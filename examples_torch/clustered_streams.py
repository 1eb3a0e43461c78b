"""Trading wireless resources for personalization (§IV-B/C + §V-D), on the
PyTorch port (``examples/clustered_streams.py``).

Runs the clustered variant for several stream counts m_t, uses the
silhouette score (Alg. 2) to pick m_t, and prices each configuration's
round time under the paper's wireless model.

  PYTHONPATH=src python examples_torch/clustered_streams.py              # on the GPU
  PYTHONPATH=src python examples_torch/clustered_streams.py --device cpu
"""
import argparse

import torch

from repro_torch.core import FedConfig, clustering, ucfl
from repro_torch.core import comm_model as cm
from repro_torch.data import synthetic
from repro_torch.device import resolve_device
from repro_torch.federated import simulation
from repro_torch.models import lenet


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="default: cuda")
    ap.add_argument("--rounds", type=int, default=10)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    apply = lenet.apply_stacked
    m, groups = 12, 4
    data = synthetic.covariate_label_shift(1, m=m, n=200, n_test=50, num_classes=8, alpha=8.0,
                                           groups=groups, hw=(16, 16), device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    params0 = lenet.init(gen, input_hw=(16, 16), channels=1, num_classes=8, device=dev)
    cfg = FedConfig(batch_size=50)

    collab = ucfl.compute_collaboration(apply, params0, data, var_batch_size=50)

    print("silhouette sweep (Alg. 2):")
    best_k, results = clustering.choose_num_streams(
        torch.Generator(device=dev).manual_seed(2), collab["W"], k_max=8)
    for k, (s, score, _) in sorted(results.items()):
        marker = " <-- chosen" if k == best_k else ""
        print(f"  k={k}: silhouette={s:+.3f} tradeoff={score:+.3f}{marker}")

    sysp = cm.SystemParams(m=m, rho=4.0, inv_mu=1.0)
    out = {}
    for k in [1, best_k, m]:
        if k == 1:
            scheme, streams = "broadcast", 1
        elif k == m:
            scheme, streams = "unicast", m
        else:
            scheme, streams = "groupcast", k
        strat = ucfl.make_ucfl(apply, params0, cfg, num_streams=None if k == m else k,
                               var_batch_size=50, device=dev)
        h = simulation.run(strat, apply, data, 3, rounds=args.rounds, eval_every=args.rounds,
                           device=dev)
        rt = cm.round_time(sysp, scheme, streams)
        out[k] = (h.final_avg, rt)
        print(f"streams={k:3d}: avg_acc={h.final_avg:.3f} round_time={rt:.1f}·T_dl  "
              f"(acc/time={h.final_avg / rt:.4f})")
    return out


if __name__ == "__main__":
    main()
