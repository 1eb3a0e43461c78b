"""Time the Gram, mix, cohort and k-means kernels of two trees of the port on one GPU, in turns.

    python3 kernel_turns.py OTHER_TREE [--out FILE]

OTHER_TREE is another checkout of this repository (for example the parent
commit, unpacked with ``git archive``). The kernels of OTHER_TREE and of
this tree are timed in four turns, other, this, this, other, each turn a
process of its own that imports that tree's ``repro_torch`` and builds its
kernels into that tree's ``build/kernels``. A turn checks each kernel
against the plain version (mix and mix-scatter within 1e-5 of the largest
output, gather and k-means labels equal) and times with CUDA events, as
``chip_smoke.time_ms`` does: medians of 30 calls after an L2-evicting
write and a spin hiding the enqueue; the mix, the mix-scatter, the gather
and their library calls also after an L2-evicting read, which leaves no
dirty lines for the timed call to write back. Shapes: mix W (k, 100) ·
θ (100, 47,616) at k = 100, 50 and 4 (the tile route); the train step's
mix at stablelm-1.6b's widest leaf, (k, 4) · (4, 205,520,896) at k = 4,
2 and 1, f32 through the kernel and bf16 through the tree's aggregation
rules on a one-leaf tree (``user_centric``, ``mix_centroids``,
``fedavg``: in a tree without bf16 θ, its f32 copy and cast back
included), beside ``w.to(θ.dtype) @ θ`` and, where the tree has the
few-row route, its tile route; chip_smoke's cohort, 50 slots (42
members, 8 pads) of the (100, 47,616) slab, for masked_mix_scatter
(library: ``w_live @ theta`` then ``index_copy_``) and cohort_gather
(library: ``index_select``); kmeans_assign of 100 points of width 100
(softmax rows, as W's) against 4 and 99 centroids drawn from them; gram
of the special round's slab-wide rows, (100, 47,616) with the 45 columns
past 47,571 zero, and of (512, 47,616), beside ``g @ g.T`` in full f32,
both after either flush; gram at the collaboration round's few rows,
(4, 616,599,552) (stablelm-1.6b's) and (4, 427,136), 1e-2-normal, beside
``g @ g.T``, each tree's error against an f64 Gram printed; and a
one-element ``zero_()``, the launch floor. A tree whose gram has the
few-row route (``pairwise_delta.rows_plan``) also times its two routes
against each other at m = 4, 8, 12 and 16 (the crossover behind M_ROWS)
over 47,616 and 2^27 columns. Each turn also hashes (sha256) the outputs
of the mix (the tile route at 100 rows; the few rows at LLM width, f32 and
bf16, whose few-row route gives the tile route's bits), the mix-scatter,
the gather and gram at m = 100 and 512 (the tensor-core route) on these
fixed inputs, and keeps the ``ptxas`` lines of
its mix, mix-scatter and gram builds. Every gram output is also held to
the plain version (within 1e-5 of the largest entry; at the few rows'
LLM width within 5e-4 of an f64 Gram's), exactly symmetric, and to itself
(two calls bit-equal).
Prints one line a turn and, last, one JSON object with every turn and
whether each hash agrees across the trees; ``--out`` also writes it to a
file. Exits non-zero if a hash differs. Needs CUDA; imports nothing of
jax or of the reference package.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 0


def time_ms(fn, dev, reps=30, flush="write"):
    """Median CUDA-event time of ``fn`` with a cold L2 (chip_smoke's). The
    256 MB flush is chip_smoke's ``zero_()`` (``flush="write"``), which
    leaves the L2 full of dirty lines for the timed call to write back, or
    a ``sum()`` that reads it (``flush="read"``), which leaves clean ones."""
    import torch
    buf = torch.empty(64 * 2**20, dtype=torch.float32, device=dev)
    fn()
    torch.cuda.synchronize(dev)
    times = []
    for _ in range(reps):
        if flush == "write":
            buf.zero_()
        else:
            buf.sum()
        torch.cuda._sleep(2_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def sha256(t) -> str:
    import torch
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:  # numpy has no bf16: hash its 16-bit patterns
        t = t.view(torch.int16)
    return hashlib.sha256(t.numpy().tobytes()).hexdigest()


def ptxas_lines(build, source: str) -> list:
    """The register, shared-memory and spill lines of ``source``'s build log."""
    log = build.target(source).with_suffix(".log")
    return [ln.split("ptxas info    : ")[-1] for ln in log.read_text().splitlines()
            if "Used" in ln or "spill" in ln] if log.exists() else []


def cohort_turn(out, dev, gen, m, d, c=50, real=42):
    """masked_mix_scatter and cohort_gather at chip_smoke's cohort: 50
    slots of the (m, d) slab, ``real`` sorted members, then pads (the
    sentinel m, mask off, W's pad columns 0), into ``out``."""
    import torch
    from repro_torch.kernels import ops, ref
    full = torch.randn(m, d, generator=gen, device=dev)
    members = torch.sort(torch.randperm(m, generator=gen, device=dev)[:real]).values
    idx = torch.full((c,), m, dtype=torch.int32, device=dev)
    idx[:real] = members.to(torch.int32)
    mask = torch.arange(c, device=dev) < real
    w = torch.zeros(c, c, device=dev)
    w[:, :real] = torch.softmax(torch.randn(c, real, generator=gen, device=dev), dim=1)
    theta = 0.05 * torch.randn(c, d, generator=gen, device=dev)

    got = ops.masked_mix_scatter(w, theta, idx, mask, full.clone(), impl="cuda")
    want = ref.masked_mix_scatter(w, theta, idx, mask, full)
    err = float((got - want).abs().max())
    if not err <= 1e-5 * float(want.abs().max()):
        raise AssertionError(f"masked_mix_scatter max_abs_err {err:.3e}")
    out["mix_scatter_sha256"] = sha256(got)
    gathered = ops.cohort_gather(full, idx, impl="cuda")
    if not torch.equal(gathered, ref.cohort_gather(full, idx)):
        raise AssertionError("cohort_gather differs from the plain version")
    out["gather_sha256"] = sha256(gathered)

    scratch = full.clone()
    live = idx[:real].long()
    w_live = w[:real].contiguous()
    safe = idx.long().clamp(max=m - 1)
    for flush, tag in (("write", ""), ("read", "_read_flush")):
        out[f"mix_scatter{tag}_ms"] = time_ms(
            lambda: ops.masked_mix_scatter(w, theta, idx, mask, scratch, impl="cuda"), dev,
            flush=flush)
        out[f"mix_scatter_library{tag}_ms"] = time_ms(
            lambda: scratch.index_copy_(0, live, w_live @ theta), dev, flush=flush)
        out[f"gather{tag}_ms"] = time_ms(
            lambda: ops.cohort_gather(full, idx, impl="cuda"), dev, flush=flush)
        out[f"gather_library{tag}_ms"] = time_ms(lambda: full.index_select(0, safe), dev,
                                                 flush=flush)


def gram_f64(g, chunk=2**24):
    """G Gᵀ in f64, summed over column chunks of ``g`` (chip_smoke's)."""
    import torch
    out = torch.zeros(g.shape[0], g.shape[0], dtype=torch.float64, device=g.device)
    for c0 in range(0, g.shape[1], chunk):
        x = g[:, c0: c0 + chunk].double()
        out += x @ x.T
    return out


def gram_check(g, got, tag, against_f64=False):
    """gram's output ``got`` on ``g``: exactly symmetric, within 1e-5 of
    the plain version's largest entry (with ``against_f64``, within 5e-4
    of an f64 Gram's; returns that share)."""
    import torch
    from repro_torch.kernels import ref
    if not torch.equal(got, got.T):
        raise AssertionError(f"gram {tag}: not exactly symmetric")
    want = gram_f64(g) if against_f64 else ref.gram(g)
    err = float((got.double() - want.double()).abs().max()) / float(want.abs().max())
    if not err <= (5e-4 if against_f64 else 1e-5):
        raise AssertionError(f"gram {tag}: error {err:.3e} of the largest entry")
    return err


def gram_turn(out, dev, gen):
    """gram at the special round's (100, 47,616) rows and at 512 clients:
    checked against the plain version and against a second call, hashed,
    then timed beside ``g @ g.T`` after either flush; then at the few
    rows, (4, 616,599,552) and (4, 427,136), checked likewise (the wide
    one against an f64 Gram) and timed beside ``g @ g.T``."""
    import torch
    from repro_torch.kernels import ops
    for m in (100, 512):
        g = 1e-2 * torch.randn(m, 47616, generator=gen, device=dev)
        if m == 100:
            g[:, 47571:] = 0.0  # the slab's pad columns
        got = ops.gram(g, impl="cuda")
        gram_check(g, got, f"m={m}")
        if not torch.equal(got, ops.gram(g, impl="cuda")):
            raise AssertionError(f"gram m={m}: two calls gave different bits")
        out[f"gram_m{m}_sha256"] = sha256(got)
        for flush, tag in (("write", ""), ("read", "_read_flush")):
            out[f"gram_m{m}{tag}_ms"] = time_ms(lambda g=g: ops.gram(g, impl="cuda"), dev,
                                                flush=flush)
            out[f"gram_m{m}_library{tag}_ms"] = time_ms(lambda g=g: g @ g.T, dev, flush=flush)
    for d, reps in ((616_599_552, 10), (427_136, 30)):
        g = 1e-2 * torch.randn(4, d, generator=gen, device=dev)
        got = ops.gram(g, impl="cuda")
        err = gram_check(g, got, f"(4, {d})", against_f64=d > 2**24)
        if not torch.equal(got, ops.gram(g, impl="cuda")):
            raise AssertionError(f"gram (4, {d}): two calls gave different bits")
        out[f"gram_m4_d{d}_err"] = err
        out[f"gram_m4_d{d}_ms"] = time_ms(lambda g=g: ops.gram(g, impl="cuda"), dev, reps)
        out[f"gram_m4_d{d}_library_ms"] = time_ms(lambda g=g: g @ g.T, dev, reps)
        del g, got
        torch.cuda.empty_cache()


def forced_gram(pd, g, plan):
    """gram of the aligned rows ``g`` launched on ``plan``, a route's plan
    for their shape (``pd``: the tree's ``pairwise_delta``), through its
    C entry as ``gram_cuda`` launches ``gram_plan``'s."""
    import ctypes
    import torch
    m, d = g.shape
    out = torch.empty((m, m), dtype=torch.float32, device=g.device)
    vals = plan.values()
    values = (ctypes.c_longlong * len(vals))(*vals)
    stream = torch.cuda.current_stream(g.device).cuda_stream
    counters, partial = pd._workspace(g.device, stream, plan.partial_floats)
    pd.GRAM.launch(g.device, stream, g.data_ptr(), g.stride(0), m, d,
                   ctypes.cast(values, ctypes.c_void_p), len(vals), partial.data_ptr(),
                   partial.numel(), counters.data_ptr(), out.data_ptr())
    return out


def crossover_turn(out, dev, gen):
    """Both routes of gram at one m, each launched on its own plan, where
    the tree has the few-row route: m = 4, 8, 12, 16 over 47,616 and 2^27
    columns, each output held to the plain version or an f64 Gram."""
    import torch
    from repro_torch.kernels import pairwise_delta as pd
    if not hasattr(pd, "rows_plan"):
        return
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for d, reps in ((47616, 30), (2**27, 10)):
        for m in (4, 8, 12, 16):
            g = 1e-2 * torch.randn(m, d, generator=gen, device=dev)
            plans = (("rows", pd.rows_plan(m, d, sms)), ("tiles", pd.tile_plan(m, d, sms)))
            for route, plan in plans:
                gram_check(g, forced_gram(pd, g, plan), f"({m}, {d}) {route}",
                           against_f64=d > 2**24)
                out[f"crossover_{route}_m{m}_d{d}_ms"] = time_ms(
                    lambda g=g, plan=plan: forced_gram(pd, g, plan), dev, reps)
            del g
            torch.cuda.empty_cache()


def few_rows_turn(out, dev, gen, d=205_520_896, reps=10):
    """The train step's mix at stablelm-1.6b's widest leaf, (k, 4) · (4, d)
    at k = 4, 2, 1, in f32 and bf16, each checked against the plain version
    (f32 within 1e-5 of the largest output, bf16 within one bf16 step of
    each output plus that) and hashed: the tree's kernel on the f32 θ; on
    the bf16 θ the tree's ``aggregation.user_centric`` (k = 4), ``mix_centroids``
    (k = 2) and ``fedavg`` (k = 1) over a one-leaf tree, whatever casts the
    tree makes around the kernel (the parent's f32 copy and cast back), and,
    where the kernel takes a bf16 θ, the kernel alone. A tree with the
    few-row route (``mix_aggregate.rows_plan``) also times its tile route
    (``route="tiles"``) at each shape."""
    import torch
    from repro_torch.core import aggregation
    from repro_torch.kernels import mix_aggregate as mix
    from repro_torch.kernels import ops, ref
    theta = 0.02 * torch.randn(4, d, generator=gen, device=dev)
    labels = torch.tensor([0, 1, 1, 0], device=dev)
    for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        th = theta.to(dtype)
        tree = {"leaf": th}
        for k in (4, 2, 1):
            # k = 1 is fedavg's mean over 4 equal clients
            w = (torch.softmax(torch.randn(k, 4, generator=gen, device=dev), dim=1) if k > 1
                 else torch.full((1, 4), 0.25, device=dev))
            calls = {"kernel": lambda w=w: ops.mix_aggregate(w, th, impl="cuda")}
            if dtype == torch.bfloat16:
                if k == 4:
                    calls["user_centric"] = lambda w=w: aggregation.user_centric(tree, w)
                elif k == 2:
                    calls["mix_centroids"] = lambda w=w: aggregation.mix_centroids(tree, w, labels)
                else:
                    calls["fedavg"] = lambda: aggregation.fedavg(tree, torch.ones(4, device=dev))
                if th.dtype not in getattr(ops, "MIX_DTYPES", (torch.float32,)):
                    del calls["kernel"]
            want = ref.mix_aggregate(w, th)
            for name, fn in calls.items():
                got = fn()
                got = got["leaf"] if isinstance(got, dict) else got
                if name == "mix_centroids":
                    got = got[:2]  # clients 0 and 1 hold the two rules' mixes
                elif name == "fedavg":
                    got = got[:1]
                diff = (got.float() - want.float()).abs()
                allowed = 1e-5 * float(want.float().abs().max())
                if dtype == torch.bfloat16:
                    allowed = allowed + 2.0 ** -7 * want.float().abs()
                if not bool((diff <= allowed).all()):
                    raise AssertionError(f"few rows k={k} {tag} {name}: off the plain version")
                out[f"rows_k{k}_{tag}_{name}_sha256"] = sha256(got)
                out[f"rows_k{k}_{tag}_{name}_ms"] = time_ms(fn, dev, reps)
                del got, diff
            out[f"rows_k{k}_{tag}_library_ms"] = time_ms(lambda w=w: w.to(dtype) @ th, dev, reps)
            if hasattr(mix, "rows_plan"):
                out[f"rows_k{k}_{tag}_tiles_ms"] = time_ms(
                    lambda w=w: mix.mix_aggregate_cuda(w, th, route="tiles"), dev, reps)
            del want
            torch.cuda.empty_cache()
        del th, tree
    del theta
    torch.cuda.empty_cache()


def one_turn(tree: Path) -> dict:
    """Check and time the kernels of the port in ``tree``."""
    import torch
    sys.path.insert(0, str(tree / "src"))
    from repro_torch.kernels import _build, ops, ref

    if not torch.cuda.is_available():
        raise SystemExit("kernel_turns: torch.cuda.is_available() is false")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    m, d = 100, 47616
    theta = 0.05 * torch.randn(m, d, generator=gen, device=dev)
    out = {"tree": str(tree)}
    for k in (100, 50, 4):
        w = torch.softmax(torch.randn(k, m, generator=gen, device=dev), dim=1)
        want = ref.mix_aggregate(w, theta)
        err = float((ops.mix_aggregate(w, theta, impl="cuda") - want).abs().max())
        if not err <= 1e-5 * float(want.abs().max()):
            raise AssertionError(f"{tree}: mix k={k} max_abs_err {err:.3e}")
        out[f"mix_k{k}_sha256"] = sha256(ops.mix_aggregate(w, theta, impl="cuda"))
        for flush, tag in (("write", ""), ("read", "_read_flush")):
            out[f"mix_k{k}{tag}_ms"] = time_ms(
                lambda w=w: ops.mix_aggregate(w, theta, impl="cuda"), dev, flush=flush)
            out[f"mix_k{k}_library{tag}_ms"] = time_ms(lambda w=w: w @ theta, dev, flush=flush)
    cohort_turn(out, dev, gen, m, d)
    del theta
    few_rows_turn(out, dev, gen)
    pts = torch.softmax(4.0 * torch.randn(m, m, generator=gen, device=dev), dim=1)
    for k in (4, 99):
        cents = pts[torch.randperm(m, generator=gen, device=dev)[:k]].clone()
        if not torch.equal(ops.kmeans_assign(pts, cents, impl="cuda")[0],
                           ref.kmeans_assign(pts, cents)[0]):
            raise AssertionError(f"{tree}: kmeans k={k} labels differ from the plain version")
        out[f"kmeans_k{k}_ms"] = time_ms(
            lambda c=cents: ops.kmeans_assign(pts, c, impl="cuda"), dev)
    gram_turn(out, dev, gen)
    crossover_turn(out, dev, gen)
    one = torch.empty(1, device=dev)
    out["zero_1_ms"] = time_ms(lambda: one.zero_(), dev)
    out["device"] = torch.cuda.get_device_name(0)
    out["ptxas"] = {src: ptxas_lines(_build, src)
                    for src in ("mix_aggregate.cu", "masked_mix_scatter.cu", "gram.cu")}
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", type=Path, help="another checkout of the repository")
    ap.add_argument("--out", type=Path, help="also write the JSON object here")
    ap.add_argument("--turn", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.turn:  # a child: one tree
        print(json.dumps(one_turn(args.other.resolve())))
        return
    other = args.other.resolve()
    if not (other / "src" / "repro_torch").is_dir():
        raise SystemExit(f"kernel_turns: {other} holds no src/repro_torch")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    turns = []
    for label, tree in (("other", other), ("this", ROOT), ("this", ROOT), ("other", other)):
        res = subprocess.run([sys.executable, str(Path(__file__).resolve()), str(tree), "--turn"],
                             capture_output=True, text=True, timeout=900)
        if res.returncode != 0:
            raise SystemExit(f"kernel_turns: the {label} turn failed:\n{res.stdout}\n{res.stderr}")
        got = json.loads(res.stdout.strip().splitlines()[-1])
        got["turn"] = label
        turns.append(got)
        print(f"{label}: " + "  ".join(f"{k} {v:.4f}" for k, v in got.items()
                                      if isinstance(v, float)), flush=True)
    hashes = sorted(k for k in turns[0] if k.endswith("_sha256"))
    agree = {k: len({t.get(k) for t in turns}) == 1 for k in hashes}
    result = {"card": smi, "turns": turns, "hashes_agree": agree}
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(result, indent=1))
    print(json.dumps(result))
    if not all(agree.values()):
        raise SystemExit(f"kernel_turns: outputs differ between the trees: {agree}")


if __name__ == "__main__":
    main()
