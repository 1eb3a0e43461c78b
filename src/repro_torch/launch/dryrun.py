"""Dry run: count every (arch × shape × mesh) step on the meta device
(``repro.launch.dryrun``).

The reference lowers and compiles each combo for 512 forced host devices
and reads XLA's analyses. The port builds the same step with the
reference's abstract inputs as ``meta`` tensors (:mod:`repro_torch.launch.steps`)
and runs it once under :func:`repro_torch.launch.op_analysis.counting`: no
device, no allocation and no CUDA, so kimi-k2's 1 T parameters count on a
laptop. Each combo's counts are rank 0's of a dry mesh
(:func:`repro_torch.launch.mesh.make_dry_mesh`):

  * the port keeps the reference's choices: ``cfg.for_mesh`` (head and
    vocab padding to the "model" axis) and the unpadded parameter count
    for MODEL_FLOPS; ``long_500k`` served by the whole mesh with no client
    axis; the mix inputs of each ``agg``; ``moe.set_ep_mesh``;
  * a rank holds its clients' rows (one client a data position), the
    rank's experts under expert parallelism and every other weight whole:
    the port has no tensor-parallel dense layers, so the ranks of the
    "model" axis repeat the dense work that the reference splits over them
    (ROADMAP C2), and a request served by the whole mesh is computed whole
    on every rank;
  * a decode step runs at the cache's last position (``seq_len − 1``; a
    learned position table's last row where the config has one), where it
    attends over the whole prefix.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun \\
      --arch all --shape all --mesh card --agg user_centric --out results/dryrun_torch

``--mesh`` takes ``card`` (1, 1), the default: one H100; ``single`` (16, 16)
and ``multi`` (2, 16, 16), the reference's production meshes, counted for
rank 0; or a shape ``DxM`` / ``PxDxM``. Each combo writes ``<tag>.json``
with the reference's keys (:meth:`repro_torch.launch.roofline.Roofline.to_dict`,
plus ``t_lower_s``, the trace's seconds, ``t_compile_s`` 0: nothing
compiles) and ``<tag>.ops.json.gz``, the op table that
:mod:`repro_torch.launch.attribute` reads; a combo that fails writes
``<tag>.FAILED`` (its traceback) and the run exits 1.
"""
from __future__ import annotations

import argparse
import dataclasses
import gzip
import json
import os
import time
import traceback

import torch

from repro_torch import configs
from repro_torch.configs.base import INPUT_SHAPES
from repro_torch.core.pytree import tree_map
from repro_torch.launch import mesh as meshlib
from repro_torch.launch import op_analysis, roofline, sharding, steps
from repro_torch.models import moe, transformer

META = steps.META


def make_mesh(name: str):
    """The dry mesh a ``--mesh`` name gives: ``card``, ``single``, ``multi``,
    or a shape ``DxM`` ("data", "model") / ``PxDxM`` ("pod", "data", "model")."""
    if name == "card":
        return meshlib.make_dry_mesh((1, 1), ("data", "model"))
    if name in ("single", "multi"):
        return meshlib.make_production_mesh(multi_pod=name == "multi", dry=True)
    dims = tuple(int(x) for x in name.split("x"))
    axes = {2: ("data", "model"), 3: ("pod", "data", "model")}.get(len(dims))
    if axes is None:
        raise ValueError(f"--mesh {name!r}: expected card, single, multi, DxM or PxDxM")
    return meshlib.make_dry_mesh(dims, axes)


def _mix_inputs(agg: str, m: int, num_streams: int):
    if agg == "user_centric":
        return torch.empty((m, m), dtype=torch.float32, device=META)
    if agg == "clustered":
        return (torch.empty((num_streams, m), dtype=torch.float32, device=META),
                torch.empty((m,), dtype=torch.int32, device=META))
    return ()


def _rows(tree, k: int):
    """A meta tree with its leading axis cut to ``k`` rows (a rank's)."""
    return tree_map(lambda x: torch.empty((k,) + tuple(x.shape[1:]), dtype=x.dtype,
                                          device=META), tree)


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in op_analysis.tensors(tree))


def _rank_params(cfg, rows):
    """A rank's params on meta: ``rows`` clients' (one model's when None),
    under expert parallelism (``moe.set_ep_mesh``) only its block of every
    expert leaf."""
    if rows is None and cfg.family == "moe":
        block = sharding.expert_block(cfg, moe.ep_mesh())
        return transformer.init(None, cfg, META, expert_block=block)
    return steps.abstract_params(cfg, n_clients=rows)


def trace_one(cfg, shape, mesh, *, agg: str, num_streams: int = 4,
              remat_policy: str | None = None, expert_parallel: bool = True):
    """Build one combo's step on meta and count it for rank 0 of ``mesh``.
    Returns (Analysis, meta): the counts with ``memory`` (argument bytes of
    params, opt, mix, batch and caches, output bytes, peak temp bytes), and
    chips, clients, trace seconds, the unpadded one-model params and
    whether the step is federated."""
    moe.set_ep_mesh(mesh if (expert_parallel and cfg.expert_axis) else None)
    try:
        return _trace(cfg, shape, mesh, agg, num_streams, remat_policy)
    finally:
        moe.set_ep_mesh(None)


def _trace(cfg, shape, mesh, agg, num_streams, remat_policy):
    t0 = time.perf_counter()
    chips = meshlib.num_chips(mesh)
    m = meshlib.num_clients(mesh)
    federated = cfg.regime == "federated"
    abs_params_true = steps.abstract_params(cfg)
    cfg = cfg.for_mesh(mesh.shape["model"])
    if remat_policy is not None:
        cfg = dataclasses.replace(cfg, remat_policy=remat_policy)
    if shape.kind == "decode" and shape.global_batch < m:
        # long_500k: one request served by the whole mesh, no client axis
        federated_step, n_clients = False, None
    else:
        federated_step = federated
        n_clients = m if federated else None
    shards = mesh.clients().shards
    # a step with no client axis splits its batch over the client axes
    # where it divides (the EP fedsgd step, serving under EP)
    split = n_clients is None and shards > 1 and shape.global_batch % shards == 0
    fn, parts, args = make_step(
        cfg, shape, agg=agg, n_clients=m, rows=None if n_clients is None else m // shards,
        batch_rows=shape.global_batch // shards if split else None,
        num_streams=num_streams, gather=mesh if federated_step and m > 1 else None)
    ana = count_step(fn, parts, args)
    meta = {"chips": chips, "clients": m, "t_lower_s": time.perf_counter() - t0,
            "t_compile_s": 0.0, "abs_params_one": abs_params_true,
            "federated_step": federated_step}
    return ana, meta


def make_step(cfg, shape, *, agg: str, n_clients: int, rows: int | None, batch_rows=None,
              num_streams: int = 4, gather=None):
    """One step of ``shape.kind`` and its arguments as meta tensors: returns
    ``(fn, parts, args)``, ``parts`` naming each argument tree (params, opt,
    mix, batch, caches) and ``args`` what ``fn`` takes.

    ``rows`` is the clients a rank holds (None: one model, no client axis;
    the fedsgd regime's), ``n_clients`` the step's m (W is (m, m));
    ``batch_rows`` a rank's slice of the global batch when there is no
    client axis (its requests and caches too); ``gather``
    the mesh that the train step all-gathers the clients' rows over
    (``mix_gather_shardings``). A decode step runs at the cache's last
    position (a learned position table's last row where it is shorter)."""
    fed = rows is not None
    if not fed and batch_rows is not None:
        shape = dataclasses.replace(shape, global_batch=batch_rows)
    params = _rank_params(cfg, rows)
    parts = {"params": params}
    batch = steps.input_specs(cfg, shape, n_clients=n_clients if fed else None)
    if fed:
        batch = _rows(batch, rows)
    if shape.kind == "train":
        parts["opt"] = steps.abstract_opt(params, momentum=cfg.momentum)
        fn = steps.build_train_step(cfg, n_clients=n_clients, agg=agg, lr=0.1,
                                    momentum=cfg.momentum, mix_gather_shardings=gather)
        if fed:
            parts["mix"] = _mix_inputs(agg, n_clients, num_streams)
        parts["batch"] = batch
        args = tuple(parts.values())
    elif shape.kind == "prefill":
        parts["batch"] = batch
        fn = steps.build_prefill_step(cfg, federated=fed)
        args = (params, batch)
    else:
        parts["batch"] = batch
        caches = steps.abstract_cache(cfg, shape, n_clients=n_clients if fed else None)
        parts["caches"] = caches = _rows(caches, rows) if fed else caches
        fn = steps.build_serve_step(cfg, federated=fed)
        pos = shape.seq_len - 1 if not cfg.max_pos else min(shape.seq_len, cfg.max_pos) - 1
        args = (params, caches, batch["tokens"], pos)
    return fn, parts, args


def count_step(fn, parts, args):
    """The :class:`repro_torch.launch.op_analysis.Analysis` of ``fn(*args)``
    on meta, every part's storages live from the start, with ``memory``:
    argument bytes (and each part's), output bytes, peak and temp bytes."""
    with op_analysis.counting() as counter:
        for part in parts.values():
            counter.track(part)
        out = fn(*args)
        ana = counter.analysis
        out_bytes = _nbytes(out)
    ana.memory = {
        "argument_bytes": ana.argument_bytes,
        "output_bytes": out_bytes,
        "temp_bytes": ana.peak_bytes - ana.argument_bytes,
        "peak_bytes": ana.peak_bytes,
        **{f"{name}_bytes": _nbytes(part) for name, part in parts.items()},
    }
    return ana


def run_combo(arch: str, shape_name: str, mesh_name: str, *, agg: str, num_streams: int,
              out_dir: str, skip_existing: bool, sharding_mode: str = "tp",
              remat_policy: str | None = None):
    tag = f"{arch}__{shape_name}__{mesh_name}__{agg}"
    if sharding_mode != "tp":
        tag += f"__{sharding_mode}"
    if remat_policy:
        tag += f"__{remat_policy}"
    path = os.path.join(out_dir, tag + ".json")
    if skip_existing and os.path.exists(path):
        print(f"[skip] {tag}")
        return True
    cfg = configs.get(arch)
    shape = INPUT_SHAPES[shape_name]
    if shape_name == "long_500k" and not cfg.long_context_ok:
        print(f"[n/a ] {tag} (full-attention arch; skip per DESIGN.md)")
        return True
    os.makedirs(out_dir, exist_ok=True)
    try:
        if sharding_mode != "tp":
            raise NotImplementedError(
                f"--sharding {sharding_mode}: the port splits no dense weight over the mesh "
                "(only the MoE experts, launch/sharding.py); every other weight is whole on "
                "every rank, which --sharding tp counts")
        ana, meta = trace_one(cfg, shape, make_mesh(mesh_name), agg=agg,
                              num_streams=num_streams, remat_policy=remat_policy)
        roof = roofline.analyze(ana, cfg, shape, mesh_name=mesh_name, chips=meta["chips"],
                                agg=agg, abs_params_one=meta["abs_params_one"])
        d = roof.to_dict()
        for k in ("t_lower_s", "t_compile_s", "clients", "federated_step"):
            d[k] = meta[k]
        with open(path, "w") as f:
            json.dump(d, f, indent=2, default=str)
        with gzip.open(os.path.join(out_dir, tag + ".ops.json.gz"), "wt") as f:
            json.dump({"tag": tag, "chips": meta["chips"], "rows": ana.op_rows()}, f)
        print(f"[ok  ] {roofline.fmt_row(roof)} (trace {meta['t_lower_s']:.1f}s)")
        return True
    except Exception as e:
        with open(os.path.join(out_dir, tag + ".FAILED"), "w") as f:
            f.write(traceback.format_exc())
        print(f"[FAIL] {tag}: {type(e).__name__}: {str(e)[:200]}")
        return False


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="card",
                    help="card (1, 1), single (16, 16), multi (2, 16, 16), both (single and "
                         "multi), or a shape DxM / PxDxM; comma-separable")
    ap.add_argument("--agg", default="user_centric",
                    choices=["user_centric", "clustered", "fedavg", "local"])
    ap.add_argument("--num-streams", type=int, default=4)
    ap.add_argument("--sharding", default="tp", choices=["tp", "fsdp"])
    ap.add_argument("--remat-policy", default=None,
                    choices=[None, "full", "dots", "save_moe"])
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)

    archs = (sorted(configs.ARCHITECTURES) if args.arch == "all"
             else args.arch.split(","))
    shapes = (list(INPUT_SHAPES) if args.shape == "all"
              else args.shape.split(","))
    meshes = ["single", "multi"] if args.mesh == "both" else args.mesh.split(",")

    ok = True
    for arch in archs:
        for shape in shapes:
            for mesh_name in meshes:
                ok &= run_combo(arch, shape, mesh_name, agg=args.agg,
                                num_streams=args.num_streams, out_dir=args.out,
                                skip_existing=args.skip_existing,
                                sharding_mode=args.sharding,
                                remat_policy=args.remat_policy)
    raise SystemExit(0 if ok else 1)


if __name__ == "__main__":
    main()
