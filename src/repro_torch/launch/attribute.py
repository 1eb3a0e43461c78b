"""Dry-run "profiler": attribute one rank's FLOPs, bytes and collective
traffic to ops and to the port's functions (``repro.launch.attribute``).

The reference walks a saved partitioned HLO (``.hlo.zst``) and keys each
contributor by its ``op_name`` metadata. The port's dry run
(:mod:`repro_torch.launch.dryrun`) saves its op table instead,
``<tag>.ops.json.gz`` (gzip'd JSON): one row for each aten op, kernel call
and collective, keyed by the op (or the kernel's launch counter, or the
collective's kind) and the ``repro_torch`` function that issued it. This
tool prints the top contributors of each table.

  PYTHONPATH=src python -m repro_torch.launch.attribute \\
      results/dryrun_torch/gemma2-9b__train_4k__card__user_centric.ops.json.gz
"""
from __future__ import annotations

import argparse
import gzip
import json
import sys
from collections import defaultdict


def load_ops(path: str) -> dict:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        return json.load(f)


def attribute(rows):
    """(collectives, bytes, flops): each {key: [value, count]}, the key
    ``"<kind> <op>  <issuer>"``."""
    colls = defaultdict(lambda: [0.0, 0])
    bytes_by = defaultdict(lambda: [0.0, 0])
    flops_by = defaultdict(lambda: [0.0, 0])
    for r in rows:
        key = f"{r['kind']:10s} {r['op']:28s} {r['issuer'][:90]}"
        if r["kind"] == "collective":
            colls[key][0] += r["moved_bytes"]
            colls[key][1] += r["count"]
            continue
        if r["bytes"]:
            bytes_by[key][0] += r["bytes"]
            bytes_by[key][1] += r["count"]
        if r["flops"]:
            flops_by[key][0] += r["flops"]
            flops_by[key][1] += r["count"]
    return colls, bytes_by, flops_by


def report(path: str, *, top=25, out=sys.stdout):
    data = load_ops(path)
    colls, bytes_by, flops_by = attribute(data["rows"])
    p = lambda *a: print(*a, file=out)
    p(f"{data['tag']}: rank 0 of {data['chips']}")
    for title, table, unit, scale in (
        ("COLLECTIVE moved bytes", colls, "GB", 1e9),
        ("HBM bytes (unfused upper bound)", bytes_by, "GB", 1e9),
        ("dot FLOPs", flops_by, "GF", 1e9),
    ):
        total = sum(v[0] for v in table.values())
        p(f"\n=== {title}: total {total / scale:.2f} {unit}/rank ===")
        rows = sorted(table.items(), key=lambda kv: -kv[1][0])[:top]
        for k, (val, cnt) in rows:
            p(f"  {val / scale:10.2f} {unit} x{cnt:<6.0f} {k}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("ops_path")
    ap.add_argument("--top", type=int, default=25)
    args = ap.parse_args(argv)
    report(args.ops_path, top=args.top)


if __name__ == "__main__":
    main()
