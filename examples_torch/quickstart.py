"""Quickstart: user-centric federated learning on the PyTorch port.

The port of ``examples/quickstart.py`` onto ``repro_torch``. Builds a
concept-shift federated problem (two groups of clients with permuted
labels: collaboration across groups is poisonous), computes the paper's
collaboration coefficients in one special round, trains with user-centric
aggregation and with FedAvg, then tours the round-engine knobs a wireless
deployment cares about:

  * partial participation: a fixed-shape padded cohort a round
    (``ParticipationConfig``);
  * a quantized uplink (``FedConfig.transport``): int8 deltas and error
    feedback, about 3.9x fewer uplink bytes;
  * a two-tier topology (``FedConfig.topology``): clients upload to edge
    aggregators, and only the per-edge aggregates reach the server;
  * Pareto-biased selection (``SelectionConfig``): cohorts tilted toward
    fast clients, with a fairness lane so that nobody starves.

  PYTHONPATH=src python examples_torch/quickstart.py              # on the GPU
  PYTHONPATH=src python examples_torch/quickstart.py --device cpu
"""
import argparse

import numpy as np
import torch

from repro_torch.core import REGISTRY, FedConfig, comm_model, ucfl
from repro_torch.data import synthetic
from repro_torch.device import resolve_device
from repro_torch.federated import simulation
from repro_torch.federated.participation import ParticipationConfig, SelectionConfig
from repro_torch.federated.topology import Topology
from repro_torch.federated.transport import TransportConfig
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
    rounds = args.rounds
    apply = lenet.apply_stacked

    # 8 clients in 2 concept groups (label permutations), synthetic images
    m = 8
    data = synthetic.concept_shift(0, m=m, n=200, n_test=50, num_classes=8, groups=2,
                                   hw=(16, 16), channels=1, noise=0.9, device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    params0 = lenet.init(gen, input_hw=(16, 16), channels=1, num_classes=8, device=dev)
    cfg = FedConfig(lr=0.1, momentum=0.9, epochs=1, batch_size=50)

    # ---- the paper's special round: gradient-similarity weights (Eq. 9/10)
    collab = ucfl.compute_collaboration(apply, params0, data, var_batch_size=50)
    print("collaboration matrix W (rows = clients):")
    print(np.array_str(collab["W"].cpu().numpy(), precision=2, suppress_small=True))

    # ---- train: user-centric aggregation vs FedAvg
    for name, strat in [
        ("user-centric", ucfl.make_ucfl(apply, params0, cfg, var_batch_size=50, device=dev)),
        ("fedavg", REGISTRY["fedavg"](apply, params0, cfg, device=dev)),
    ]:
        h = simulation.run(strat, apply, data, 2, rounds=rounds, eval_every=5, verbose=True,
                           device=dev)
        print(f"--> {name}: avg={h.final_avg:.3f} worst={h.final_worst:.3f}\n")

    # ---- partial participation + quantized uplink: half the clients a
    # round (pad slots masked), int8 deltas with error feedback on the wire
    part = ParticipationConfig(cohort_size=m // 2, seed=7)
    qcfg = FedConfig(lr=0.1, momentum=0.9, epochs=1, batch_size=50,
                     transport=TransportConfig("int8"))
    strat = ucfl.make_ucfl(apply, params0, qcfg, var_batch_size=50, device=dev)
    h = simulation.run(strat, apply, data, 2, rounds=rounds, eval_every=5, participation=part,
                       device=dev)
    ul = comm_model.uplink_bytes_per_round(1, "unicast", m, cohort_size=m // 2,
                                           transport=qcfg.transport, schema=strat.wire_schema)
    raw = comm_model.uplink_bytes_per_round(1, "unicast", m, cohort_size=m // 2,
                                            schema=strat.wire_schema)
    print(f"--> cohort=4 + int8 uplink: avg={h.final_avg:.3f} "
          f"(uplink {raw / ul:.2f}x smaller)\n")

    # ---- two-tier topology: clients report to 2 edge aggregators; only the
    # per-edge partial aggregates cross the edge<->PS backhaul. The tiered
    # mix factorizes the flat rule, while the PS ingests E*k aggregate
    # streams instead of c client uploads.
    topo = Topology.contiguous(m, 2)
    tcfg = FedConfig(lr=0.1, momentum=0.9, epochs=1, batch_size=50, topology=topo)
    strat = ucfl.make_ucfl(apply, params0, tcfg, num_streams=2, var_batch_size=50, device=dev)
    tpart = ParticipationConfig(cohort_size=6, seed=7)
    h = simulation.run(strat, apply, data, 2, rounds=rounds, eval_every=5, participation=tpart,
                       device=dev)
    flat_b = comm_model.ps_uplink_bytes_per_round(1, "groupcast", m, num_streams=2,
                                                  cohort_size=6, schema=strat.wire_schema)
    hier_b = comm_model.ps_uplink_bytes_per_round(1, "groupcast", m, num_streams=2,
                                                  cohort_size=6, num_edges=2,
                                                  schema=strat.wire_schema)
    print(f"--> two-tier (E=2, k=2): avg={h.final_avg:.3f} "
          f"(PS uplink {flat_b / hier_b:.2f}x smaller)\n")

    # ---- Pareto-biased selection: favor fast clients (a 16x compute-speed
    # spread), fairness lane on so that slow clients still train
    sel = SelectionConfig(compute=np.geomspace(0.25, 4.0, m), bias=2.0)
    h = simulation.run(strat, apply, data, 2, rounds=rounds, eval_every=5, participation=part,
                       selection=sel, device=dev)
    print(f"--> pareto selection (bias=2): avg={h.final_avg:.3f} worst={h.final_worst:.3f}")
    return h


if __name__ == "__main__":
    main()
