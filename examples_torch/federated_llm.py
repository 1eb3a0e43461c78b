"""User-centric FL on a transformer-zoo architecture, on the PyTorch port
(``examples/federated_llm.py``).

Federates a reduced mamba2 LM across 4 clients whose token streams follow
two different hidden Markov chains (concept shift in LM-land), computes
the collaboration matrix on real LM gradients, and trains with the train
step that ``repro_torch.launch.dryrun`` counts
(``repro_torch.launch.steps.build_train_step``).

  PYTHONPATH=src python examples_torch/federated_llm.py              # on the GPU
  PYTHONPATH=src python examples_torch/federated_llm.py --device cpu
"""
import argparse

from repro_torch.launch import train


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="default: cuda")
    ap.add_argument("--rounds", type=int, default=15)
    args = ap.parse_args(argv)
    argv = ["--arch", "mamba2-1.3b", "--smoke", "--clients", "4", "--groups", "2",
            "--rounds", str(args.rounds), "--batch", "4", "--seq", "64", "--agg", "user_centric"]
    if args.device is not None:
        argv += ["--device", args.device]
    return train.main(argv)


if __name__ == "__main__":
    main()
