"""Time variants of the mix's few-row route on one GPU: column layouts, the store, loads in flight.

    python3 mix_variants.py [--out FILE]

The few-row route (``src/repro_torch/kernels/csrc/mix_aggregate.cu``,
``mix_rows_kernel``) mixes the columns in runs of ``run``, run j by block
j mod grid, so one build takes any layout the C entry accepts:

* ``runs``: two long runs an SM, a block each, runs of ``max(RUN_MIN,
  round_up(ceil(d / (2 · SMs)), RUN_ALIGN))`` columns (each block streams
  its own stretch of every row);
* ``stripes_<n>``: runs of n sweeps (a sweep: 256 threads x the kernel's
  loads a thread x the 16-byte pack's columns), two blocks an SM, each
  block striding over the runs, so at any time the grid works in one
  window of each row;
* ``grid_1``: runs of one sweep, a block each (the hardware starts them in
  order): ``mix_aggregate.rows_plan``'s launch at LLM width.

Source variants, each built with the port's nvcc flags into
``build/mix_variants/``: ``as_built`` (the source unchanged),
``store_cs`` (the 16-byte stores as ``st.global.cs``, evict-first) and
``loads_8`` (8 loads in flight a thread, not 16). Every output is held bit
for bit to the as-built source's ``runs`` output (no variant reorders a
sum). Shapes are the train step's widest leaves, W softmax rows, θ
normal: (k, 4) · (4, 557,842,432) at k = 4 and 1 (mamba2-1.3b), (4, 4) ·
(4, 205,520,896) (stablelm-1.6b), (2, 2) · (2, 469,762,048) (mixtral-8x7b's
expert stack), (4, 4) · (4, 106,987,520) (zamba2-2.7b), each in f32 and
bf16, and (1, 4) · (4, 47,616) (the engine's). Times are CUDA-event
medians after an L2-evicting write (``kernel_turns.time_ms``), in two
passes over the variants, the second in reverse order, beside the bytes
bound (bytes / 3.35 TB/s). Prints a line a shape and, last, one JSON
object. Needs CUDA and nvcc; imports nothing of jax or of the reference
package.
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

STORE = "  *reinterpret_cast<uint4*>(p) = v;"
STORE_CS = ('  asm volatile("st.global.cs.v4.u32 [%0], {%1, %2, %3, %4};\\n" :: "l"(p), '
            '"r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w) : "memory");')
LOADS = "constexpr int kRowLoads = 16;"
SOURCES = {"as_built": {}, "store_cs": {STORE: STORE_CS},
           "loads_8": {LOADS: "constexpr int kRowLoads = 8;"}}
LAYOUTS = ("runs", "stripes_1", "stripes_4", "stripes_16", "grid_1")
SHAPES = ((4, 4, 557_842_432), (1, 4, 557_842_432), (4, 4, 205_520_896),
          (2, 2, 469_762_048), (4, 4, 106_987_520), (1, 4, 47_616))


def build(out_dir: Path) -> dict:
    """Compile every source variant at once; returns {name: its C entry}."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.mix_aggregate import MIX
    out_dir.mkdir(parents=True, exist_ok=True)
    text = (_build.CSRC / "mix_aggregate.cu").read_text()
    procs = {}
    for name, edits in SOURCES.items():
        src = text
        for old, new in edits.items():
            if src.count(old) != 1:
                raise SystemExit(f"mix_variants: mix_aggregate.cu no longer holds {old!r} once")
            src = src.replace(old, new)
        path = out_dir / f"{name}.cu"
        path.write_text(src)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o",
             str(out_dir / f"{name}.so"), str(path)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    fns, ptxas = {}, {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"mix_variants: {name} did not build:\n{log[-3000:]}")
        ptxas[name] = registers(log)
        fn = ctypes.CDLL(str(out_dir / f"{name}.so")).mix_aggregate
        fn.argtypes, fn.restype = MIX.argtypes + [ctypes.c_void_p], ctypes.c_int
        fns[name] = fn
    return fns, ptxas


def registers(log: str) -> dict:
    """{few-row instance (mangled name): its ptxas register and spill lines}."""
    out, name = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1] if "'" in line else line
        elif name and "mix_rows_kernel" in name and ("Used" in line or "spill" in line):
            out.setdefault(name, []).append(line.split("ptxas info    : ")[-1].strip())
    return out


def layout(name: str, k: int, m: int, d: int, elem: int, sms: int):
    """(blocks, run) of a layout."""
    from repro_torch.kernels import mix_aggregate as mix
    if name == "runs":
        want = -(-d // (mix.ROW_BLOCKS_PER_SM * sms))
        run = max(mix.RUN_MIN, -(-want // mix.RUN_ALIGN) * mix.RUN_ALIGN)
        return -(-d // run), run
    sweep = mix.ROW_THREADS * max(1, 16 // m) * (16 // elem)
    n = int(name.split("_")[1])
    run = n * sweep
    runs = -(-d // run)
    return (runs if name.startswith("grid") else min(runs, mix.ROW_BLOCKS_PER_SM * sms)), run


def launch(fn, w, theta, blocks, run):
    """One call of a variant's C entry on the few-row route."""
    import torch
    k, m = w.shape
    d = theta.shape[1]
    out = torch.empty(k, d, dtype=theta.dtype, device=theta.device)
    vec = d % (16 // theta.element_size()) == 0
    err = fn(w.data_ptr(), theta.data_ptr(), out.data_ptr(), k, m, d, 1,
             int(theta.dtype == torch.bfloat16), 0, int(vec), blocks, 0, run,
             ctypes.c_void_p(torch.cuda.current_stream(theta.device).cuda_stream))
    if err != 0:
        raise SystemExit(f"mix_variants: launch failed with CUDA error {err}")
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", type=Path, help="also write the JSON object here")
    args = ap.parse_args()
    import torch
    from kernel_turns import time_ms
    if not torch.cuda.is_available():
        raise SystemExit("mix_variants: torch.cuda.is_available() is false")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    dev = torch.device("cuda")
    fns, ptxas = build(ROOT / "build" / "mix_variants")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    gen = torch.Generator(device=dev).manual_seed(0)
    result = {"card": smi, "ptxas": ptxas, "shapes": []}
    for k, m, d in SHAPES:
        base = torch.randn(m, d, generator=gen, device=dev)
        w = torch.softmax(torch.randn(k, m, generator=gen, device=dev), dim=1)
        for dtype in (torch.float32, torch.bfloat16):
            theta = base.to(dtype) if dtype != torch.float32 else base
            elem = theta.element_size()
            names = [(s, lay) for s in SOURCES for lay in LAYOUTS]
            want = launch(fns["as_built"], w, theta, *layout("runs", k, m, d, elem, sms))
            reps = 10 if d > 2**24 else 30
            times = {}
            for order in (names, names[::-1]):
                for src, lay in order:
                    plan = layout(lay, k, m, d, elem, sms)
                    if not torch.equal(launch(fns[src], w, theta, *plan), want):
                        raise SystemExit(f"mix_variants: {src} {lay} at ({k}, {m}, {d}) "
                                         f"{dtype} is not the as-built bits")
                    times.setdefault(f"{src}/{lay}", []).append(time_ms(
                        lambda f=fns[src], p=plan: launch(f, w, theta, *p), dev, reps))
            del want
            bound = ((m + k) * d * elem + 4 * k * m) / 3.35e12 * 1e3
            result["shapes"].append({"k": k, "m": m, "d": d, "dtype": str(dtype)[6:],
                                     "bound_ms": bound, "ms": times})
            print(f"({k}, {m})·({m}, {d}) {str(dtype)[6:]} bound {bound:.4f} ms: " + "  ".join(
                f"{n} {'/'.join(f'{t:.4f}' for t in ts)} ({bound / min(ts):.1%})"
                for n, ts in times.items()), flush=True)
            del theta
            torch.cuda.empty_cache()
        del base
        torch.cuda.empty_cache()
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(result, indent=1))
    print(json.dumps(result))


if __name__ == "__main__":
    main()
