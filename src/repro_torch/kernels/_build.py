"""Build the hand-written Hopper kernels and bind them with ctypes.

Every ``csrc/*.cu`` file is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface. The build runs at first use, into
``build/kernels/`` at the repository root, keyed by a hash of the source and
the flags, so a fresh checkout builds everything on its first kernel call.
All missing libraries are compiled together, one ``nvcc`` process per
source, started at once.

Each C entry point enqueues its kernel(s) on the stream it is given and
returns ``cudaGetLastError()``; :class:`Kernel` raises when that is not 0
and counts successful launches. Nothing here is imported or built when a
module of the package is imported, and there is no fallback: a failed
build or launch raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("gram.cu", "mix_aggregate.cu", "kmeans_assign.cu", "cohort_gather.cu",
           "masked_mix_scatter.cu", "flash_attention.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    raise RuntimeError("repro_torch: nvcc not found (PATH, $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin); the CUDA kernels cannot be built")


def target(source: str) -> Path:
    """The library path for ``source``: its stem plus a hash of its text,
    of every shared header in ``csrc/`` (a header edit must rebuild the
    sources that include it) and of the compiler flags."""
    h = hashlib.sha256((CSRC / source).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{Path(source).stem}-{h.hexdigest()[:16]}.so"


def build_all() -> dict[str, Path]:
    """Compile every source whose library is missing, all in parallel.

    Returns ``{source: library path}``. The compiler's report (``ptxas``
    registers, shared memory and spills) lands beside each library as
    ``<stem>-<hash>.log``. Raises with the log on any failure.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = {src: target(src) for src in SOURCES}
    procs = []
    for src, lib in out.items():
        if lib.exists():
            continue
        tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp.so")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / src)]
        procs.append((src, lib, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for src, lib, tmp, proc in procs:
        log, _ = proc.communicate()
        lib.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"--- {src} (nvcc rc {proc.returncode})\n{log}")
            continue
        os.replace(tmp, lib)  # atomic: a concurrent build sees all or nothing
    if failed:
        raise RuntimeError("repro_torch: kernel build failed\n" + "\n".join(failed))
    return out


def library(source: str) -> ctypes.CDLL:
    """The loaded library of ``source``, building all kernels if needed."""
    lib = _libs.get(source)
    if lib is None:
        path = target(source)
        if not path.exists():
            path = build_all()[source]
        lib = _libs[source] = ctypes.CDLL(str(path))
    return lib


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


class Kernel:
    """One C entry point of a kernel library, with its launch count.

    ``launches`` rises by one for every call whose enqueue succeeded, and
    nowhere else; ``chip_smoke.py`` zeroes it around the main path to show
    that the path went through the kernel.
    """

    def __init__(self, source: str, symbol: str, argtypes):
        self.source = source
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.launches = 0
        self._fn = None

    def __call__(self, device: torch.device, *args):
        """Enqueue on the device's current stream."""
        self.launch(device, stream(device), *args)

    def launch(self, device: torch.device, stream_handle, *args):
        """Enqueue on ``stream_handle`` (a ``cudaStream_t``: :func:`stream`
        or an int)."""
        if self._fn is None:
            lib = library(self.source)
            fn = getattr(lib, self.symbol)
            fn.argtypes = self.argtypes + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
            err_str = lib.cuda_error_string
            err_str.argtypes = [ctypes.c_int]
            err_str.restype = ctypes.c_char_p
            self._fn, self._err_str = fn, err_str
        with torch.cuda.device(device):
            err = self._fn(*args, stream_handle)
        if err != 0:
            msg = self._err_str(err).decode()
            raise RuntimeError(f"{self.symbol}: launch failed: CUDA error {err} ({msg})")
        self.launches += 1
