"""Time qwen2-7b's federated decode step of two trees of the port on one GPU, in turns.

    python3 serve_turns.py OTHER_TREE [--out FILE]

OTHER_TREE is another checkout of this repository (for example the parent
commit, unpacked with ``git archive``). The serve path of OTHER_TREE and of
this tree runs in four turns, other, this, this, other, each turn a process
of its own that imports that tree's ``repro_torch`` and builds its kernels
into that tree's ``build/kernels``. A turn serves qwen2-7b at full width
and depth in bf16, 2 personalized clients x 2 requests, as chip_smoke's
serve phase does:

  * ``serve()`` twice (128 teacher-forced prompt tokens, 32 greedy ones):
    the prompt's and the greedy decode's wall, and its ms a step;
  * the serve step alone on a 160-position cache: 3 blocks of 32 steps,
    each block's wall over 32 (host clock, synchronized), and their median;
  * 4 more steps under ``torch.profiler``: the device operations and the
    host's kernel launches (its ``cudaLaunchKernel``/``cuLaunchKernel``
    calls) a step, the device's busy time and idle share;
  * the decode kernel's launches a step, from its counter (one an
    attention layer, 28).

Prints the card's name and power limit, one line a turn and, last, one
JSON object with every turn; ``--out`` also writes it to a file. Needs
CUDA; imports nothing of jax or of the reference package.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
ARCH = "qwen2-7b"
CLIENTS, BATCH = 2, 2
PROMPT_LEN, DECODE_TOKENS = 128, 32
BLOCK, BLOCKS, PROFILED = 32, 3, 4
SEED = 0


def profiled(fn, dev, steps):
    """Device operations, host launches, busy ms and idle share of ``fn``
    (``steps`` decode steps), each a step where it is a count."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize(dev)
        wall_ms = (time.perf_counter() - t) * 1e3
    spans, launches = [], 0
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if not e.is_user_annotation():
                spans.append((e.start_ns() / 1e6, (e.start_ns() + e.duration_ns()) / 1e6))
        elif e.name().startswith(("cudaLaunchKernel", "cuLaunchKernel")):
            launches += 1
    busy, reach = 0.0, float("-inf")
    for start, end in sorted(spans):
        if end > reach:
            busy += end - max(start, reach)
            reach = end
    return dict(profiled_wall_ms_a_step=wall_ms / steps, device_ops_a_step=len(spans) / steps,
                host_launches_a_step=launches / steps, device_busy_ms_a_step=busy / steps,
                idle_share=1.0 - busy / wall_ms)


def one_turn(tree: Path) -> dict:
    sys.path.insert(0, str(tree / "src"))
    import torch

    from repro_torch import configs
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import FLASH_DEC
    from repro_torch.launch import serve as serve_lib
    from repro_torch.launch import steps
    from repro_torch.models import transformer

    if not torch.cuda.is_available():
        raise SystemExit("serve_turns: no CUDA device")
    dev = torch.device("cuda", 0)
    _build.build_all()
    cfg = configs.get(ARCH)
    out = {"tree": str(tree), "device": torch.cuda.get_device_name(0)}
    for i in range(2):
        res = serve_lib.serve(cfg, clients=CLIENTS, batch=BATCH, prompt_len=PROMPT_LEN,
                              decode_tokens=DECODE_TOKENS, seed=SEED, device=dev)
        out[f"serve{i}_prompt_s"] = res.prefill_s
        out[f"serve{i}_decode_s"] = res.decode_s
        out[f"serve{i}_decode_step_ms"] = res.decode_s / DECODE_TOKENS * 1e3
        del res
        torch.cuda.empty_cache()

    params = serve_lib.personalized_params(cfg, CLIENTS, SEED, dev)
    step = steps.build_serve_step(cfg, federated=True)
    length = 1 + BLOCK * BLOCKS + PROFILED
    cache = transformer.init_cache(cfg, CLIENTS, BATCH, length, dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    cur = torch.randint(0, cfg.vocab_size, (CLIENTS, BATCH, 1), generator=gen, device=dev)
    step(params, cache, cur, 0)
    FLASH_DEC.launches = 0
    walls = []
    for b in range(BLOCKS):
        torch.cuda.synchronize(dev)
        t = time.perf_counter()
        for pos in range(1 + b * BLOCK, 1 + (b + 1) * BLOCK):
            logits, cache = step(params, cache, cur, pos)
        torch.cuda.synchronize(dev)
        walls.append((time.perf_counter() - t) / BLOCK * 1e3)
    out["decode_kernel_launches_a_step"] = FLASH_DEC.launches / (BLOCK * BLOCKS)
    if not bool(torch.isfinite(logits[..., :cfg.vocab_size]).all()):
        raise AssertionError("serve_turns: non-finite logits")
    out["step_ms_blocks"] = walls
    out["step_ms"] = statistics.median(walls)
    start = 1 + BLOCK * BLOCKS
    out.update(profiled(lambda: [step(params, cache, cur, pos)
                                 for pos in range(start, start + PROFILED)], dev, PROFILED))
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
        raise SystemExit(f"serve_turns: {other} holds no src/repro_torch")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    turns = []
    for label, tree in (("other", other), ("this", ROOT), ("this", ROOT), ("other", other)):
        res = subprocess.run([sys.executable, str(Path(__file__).resolve()), str(tree), "--turn"],
                             capture_output=True, text=True, timeout=600)
        if res.returncode != 0:
            raise SystemExit(f"serve_turns: the {label} turn failed:\n{res.stdout}\n{res.stderr}")
        got = json.loads(res.stdout.strip().splitlines()[-1])
        got["turn"] = label
        turns.append(got)
        print(f"{label}: " + "  ".join(f"{k} {v:.4f}" for k, v in got.items()
                                      if isinstance(v, float)), flush=True)
    result = {"card": smi, "arch": ARCH, "turns": turns}
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(result, indent=1))
    print(json.dumps(result))


if __name__ == "__main__":
    main()
