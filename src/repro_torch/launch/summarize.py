"""Regenerate the roofline and dry-run tables from the dry run's JSON files
(``repro.launch.summarize``: its three tables, and ``--format memory``,
one rank's argument and peak bytes against the card's 80 GB).

  PYTHONPATH=src python -m repro_torch.launch.summarize results/dryrun_torch
  PYTHONPATH=src python -m repro_torch.launch.summarize results/dryrun_torch --format dryrun
  PYTHONPATH=src python -m repro_torch.launch.summarize results/dryrun_torch --format memory
  PYTHONPATH=src python -m repro_torch.launch.summarize results/dryrun_torch results/dryrun_opt --diff
"""
from __future__ import annotations

import argparse
import glob
import json
import os


def load_dir(d):
    out = {}
    for p in sorted(glob.glob(os.path.join(d, "*.json"))):
        r = json.load(open(p))
        out[(r["arch"], r["shape"], r["mesh"], r["agg"])] = r
    return out


def roofline_table(rows):
    print("| arch | shape | mesh | chips | compute s | memory s | "
          "collective s | dominant | useful |")
    print("|---|---|---|---|---|---|---|---|---|")
    for d in rows.values():
        print(f"| {d['arch']} | {d['shape']} | {d['mesh']} | {d['chips']} | "
              f"{d['compute_s']:.3f} | {d['memory_s']:.3f} | "
              f"{d['collective_s']:.3f} | {d['dominant']} | "
              f"{d['useful_flops_ratio']:.3f} |")


def dryrun_table(rows):
    print("| arch | shape | mesh | params (1 copy) | N_active | HLO GF/chip "
          "| HBM GB/chip | coll GB/chip | AG/AR/RS/A2A counts | compile s |")
    print("|---|---|---|---|---|---|---|---|---|---|")
    for d in rows.values():
        c = d["collectives"]
        cnt = "/".join(
            str(int(c.get(k, {}).get("count", 0)))
            for k in ("all-gather", "all-reduce", "reduce-scatter",
                      "all-to-all"))
        print(f"| {d['arch']} | {d['shape']} | {d['mesh']} | "
              f"{d['param_count'] / 1e9:.2f}B | "
              f"{d['active_params'] / 1e9:.2f}B | "
              f"{d['hlo_flops_per_chip'] / 1e9:.0f} | "
              f"{d['hlo_bytes_per_chip'] / 1e9:.0f} | "
              f"{d['collective_bytes_per_chip'] / 1e9:.1f} | {cnt} | "
              f"{d.get('t_compile_s', 0):.0f} |")


def memory_table(rows, device_bytes=80e9):
    """The roofline terms beside one rank's argument and peak bytes against
    the card's memory (a port table: the reference has no such columns)."""
    print("| arch | shape | mesh | compute s | memory s | collective s | dominant | useful "
          "| argument GB | peak GB | fits |")
    print("|---|---|---|---|---|---|---|---|---|---|---|")
    for d in rows.values():
        mem = d["memory_analysis"]
        fits = "yes" if mem["peak_bytes"] <= device_bytes else "no"
        print(f"| {d['arch']} | {d['shape']} | {d['mesh']} | {d['compute_s']:.4g} | "
              f"{d['memory_s']:.4g} | {d['collective_s']:.4g} | {d['dominant']} | "
              f"{d['useful_flops_ratio']:.3f} | {mem['argument_bytes'] / 1e9:.2f} | "
              f"{mem['peak_bytes'] / 1e9:.2f} | {fits} |")


def diff_table(base, opt):
    print("| arch | shape | mesh | term | baseline s | optimized s | × |")
    print("|---|---|---|---|---|---|---|")
    for key, o in opt.items():
        arch, shape, mesh, _ = key
        b = next((v for k, v in base.items()
                  if k[0] == arch and k[1] == shape and k[2] == mesh), None)
        if b is None:
            continue
        for term in ("compute_s", "memory_s", "collective_s"):
            bv, ov = b[term], o[term]
            if bv <= 0:
                continue
            print(f"| {arch} | {shape} | {mesh} | {term[:-2]} | "
                  f"{bv:.2f} | {ov:.2f} | {bv / max(ov, 1e-12):.1f}x |")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("dirs", nargs="+")
    ap.add_argument("--format", default="roofline",
                    choices=["roofline", "dryrun", "memory"])
    ap.add_argument("--diff", action="store_true")
    args = ap.parse_args()
    if args.diff:
        assert len(args.dirs) == 2
        diff_table(load_dir(args.dirs[0]), load_dir(args.dirs[1]))
        return
    rows = {}
    for d in args.dirs:
        rows.update(load_dir(d))
    {"roofline": roofline_table, "dryrun": dryrun_table,
     "memory": memory_table}[args.format](rows)


if __name__ == "__main__":
    main()
