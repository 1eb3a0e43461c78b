"""Personalized batched serving on the PyTorch port
(``examples/serve_personalized.py``).

Two federated clients each serve their own personalized gemma2-family
model with batched requests, rolling-window and global KV caches, through
``repro_torch.launch.serve`` (the tensor-core tile for the prompt and the
split-KV decode kernel on the GPU, their plain versions on the CPU).

  PYTHONPATH=src python examples_torch/serve_personalized.py              # on the GPU
  PYTHONPATH=src python examples_torch/serve_personalized.py --device cpu
"""
import argparse

from repro_torch.launch import serve


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="default: cuda")
    args = ap.parse_args(argv)
    argv = ["--arch", "gemma2-9b", "--smoke", "--clients", "2", "--batch", "2",
            "--prompt-len", "24", "--decode-tokens", "12"]
    if args.device is not None:
        argv += ["--device", args.device]
    return serve.main(argv)


if __name__ == "__main__":
    main()
