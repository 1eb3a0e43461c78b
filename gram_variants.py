"""Time variants of gram's few-row route on one GPU: the load's cache hints, threads, loads in flight.

    python3 gram_variants.py [--out FILE]

Each variant is ``src/repro_torch/kernels/csrc/gram.cu`` with one or more
of three edits: the PTX instruction of ``ld_quad`` (the float4 load of G),
``kRowThreads`` (threads a block) and ``row_unroll``'s budget (loads in
flight a thread, registers). ``as_built`` is the source unchanged. Every
variant is built with the port's nvcc flags into ``build/gram_variants/``
and launched through its own ``gram_f32`` on the few-row plan for its
thread count, on the same rows: (4, 616,599,552) (stablelm-1.6b's
collaboration round), (2, 1,713,418,240) (mixtral-8x7b's), (16, 2^27),
(4, 427,136) and (4, 47,616), 1e-2-normal. Each output is held to the
unchanged source's bits (a variant that reorders no sum gives them) or,
where it reorders them, within 1e-5 of the largest entry. Times are CUDA
event medians after an L2-evicting write (``kernel_turns.time_ms``), in
two passes over the variants, the second in reverse order, beside
``g.sum()`` (a read of the same bytes) and the bytes bound. Prints a line
a shape and, last, one JSON object. Needs CUDA and nvcc; imports nothing
of jax or of the reference package.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

LOAD = 'asm volatile("ld.global.nc.L2::256B.v4.f32 {%0, %1, %2, %3}, [%4];\\n"'
THREADS = "constexpr int kRowThreads = 256;"
UNROLL = "constexpr int by_loads = 32 / M, by_regs = (160 - M * (M + 1) / 2) / (4 * M);"
# name: (load instruction, threads a block, loads a thread, register budget)
VARIANTS = {
    "as_built": ("ld.global.nc.L2::256B.v4.f32", 256, 32, 160),
    "nc": ("ld.global.nc.v4.f32", 256, 32, 160),
    "cs": ("ld.global.cs.v4.f32", 256, 32, 160),
    "nc_no_allocate": ("ld.global.nc.L1::no_allocate.L2::256B.v4.f32", 256, 32, 160),
    "threads_512": ("ld.global.nc.L2::256B.v4.f32", 512, 32, 110),
    "loads_16": ("ld.global.nc.L2::256B.v4.f32", 256, 16, 160),
}
SHAPES = ((4, 616_599_552), (2, 1_713_418_240), (16, 2**27), (4, 427_136), (4, 47_616))


def variant_source(text: str, load: str, threads: int, loads: int, regs: int) -> str:
    for old in (LOAD, THREADS, UNROLL):
        if text.count(old) != 1:
            raise SystemExit(f"gram_variants: gram.cu no longer holds {old!r} once")
    text = text.replace(LOAD, LOAD.replace("ld.global.nc.L2::256B.v4.f32", load))
    text = text.replace(THREADS, f"constexpr int kRowThreads = {threads};")
    return text.replace(UNROLL, f"constexpr int by_loads = {loads} / M, "
                                f"by_regs = ({regs} - M * (M + 1) / 2) / (4 * M);")


def build(out_dir: Path) -> dict:
    """Compile every variant at once; returns {name: gram_f32}."""
    from repro_torch.kernels import _build
    out_dir.mkdir(parents=True, exist_ok=True)
    text = (_build.CSRC / "gram.cu").read_text()
    procs = {}
    for name, (load, threads, loads, regs) in VARIANTS.items():
        src = out_dir / f"{name}.cu"
        src.write_text(variant_source(text, load, threads, loads, regs))
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out_dir / f"{name}.so"), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    fns = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"gram_variants: {name} did not build:\n{log[-3000:]}")
        fn = ctypes.CDLL(str(out_dir / f"{name}.so")).gram_f32
        fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong,
                       ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def launch(fn, threads, g, sms, counters, partial):
    """One call of a variant's gram_f32 on the few-row plan for ``threads``."""
    import torch
    m, d = g.shape
    run = max(4 * threads, -(-(-(-d // sms)) // 4) * 4)
    blocks = -(-d // run)
    vals = [1, m, d, blocks, run, blocks * m * (m + 1) // 2]
    arr = (ctypes.c_longlong * len(vals))(*vals)
    out = torch.empty(m, m, device=g.device)
    err = fn(g.data_ptr(), g.stride(0), m, d, ctypes.cast(arr, ctypes.c_void_p), len(vals),
             partial.data_ptr(), partial.numel(), counters.data_ptr(), out.data_ptr(),
             torch.cuda.current_stream(g.device).cuda_stream)
    if err != 0:
        raise SystemExit(f"gram_variants: launch failed with CUDA error {err}")
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", type=Path, help="also write the JSON object here")
    args = ap.parse_args()
    import torch
    from kernel_turns import time_ms
    if not torch.cuda.is_available():
        raise SystemExit("gram_variants: torch.cuda.is_available() is false")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    dev = torch.device("cuda")
    fns = build(ROOT / "build" / "gram_variants")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    counters = torch.zeros(2, dtype=torch.int32, device=dev)
    partial = torch.empty(2**20, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    result = {"card": smi, "shapes": []}
    for m, d in SHAPES:
        g = 1e-2 * torch.randn(m, d, generator=gen, device=dev)
        base = launch(fns["as_built"], 256, g, sms, counters, partial)
        reps = 10 if d > 2**24 else 30
        times = {}
        for order in (list(VARIANTS), list(reversed(VARIANTS))):
            for name in order:
                threads = VARIANTS[name][1]
                got = launch(fns[name], threads, g, sms, counters, partial)
                if not (torch.equal(got, base) or float((got - base).abs().max())
                        <= 1e-5 * float(base.abs().max())):
                    raise SystemExit(f"gram_variants: {name} at ({m}, {d}) disagrees")
                times.setdefault(name, []).append(time_ms(
                    lambda fn=fns[name], t=threads: launch(fn, t, g, sms, counters, partial),
                    dev, reps))
        times["g.sum()"] = [time_ms(lambda: g.sum(), dev, reps)]
        bound = m * d * 4 / 3.35e12 * 1e3
        result["shapes"].append({"m": m, "d": d, "bound_ms": bound, "ms": times})
        print(f"({m}, {d}) bound {bound:.4f} ms: " + "  ".join(
            f"{n} {'/'.join(f'{t:.4f}' for t in ts)} ({bound / min(ts):.1%})"
            for n, ts in times.items()), flush=True)
        del g, base
        torch.cuda.empty_cache()
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(result, indent=1))
    print(json.dumps(result))


if __name__ == "__main__":
    main()
