"""Roofline terms of a counted step on one NVIDIA H100 (``repro.launch.roofline``).

Three terms per (arch × shape × mesh), as the reference's:

  compute    = Σ_kind FLOPs_kind / peak_kind                  [s]
  memory     = bytes / HBM rate                               [s]
  collective = moved collective bytes / link rate             [s]

The counts come from :mod:`repro_torch.launch.op_analysis`, which runs the
port's step on the ``meta`` device: aten matmul and convolution FLOPs by
dtype, the operand and result bytes of every aten op (an unfused upper
bound), each hand-written kernel's work from its work function below,
and the collectives of a dry rank mesh with ring accounting. Every count
is one rank's.

The constants are data-sheet figures of the NVIDIA H100 SXM5 80GB HBM3
(700 W), not measurements: HBM3 3.35 TB/s; dense bf16/fp16 tensor cores
989 TFLOP/s, TF32 495 TFLOP/s, f32 on the CUDA cores 67 TFLOP/s; NVLink 4
at 900 GB/s both ways, counted as 450 GB/s a direction for the collective
term. The port runs with TF32 off (ROADMAP C2), so an f32 product counts
at the CUDA cores' 67 TFLOP/s, and gram's 3xTF32 products at 495 / 3
(its few-row route's f32 products at 67).

MODEL_FLOPS is the textbook 6·N·D (train) / 2·N·D (forward only), with N
replaced by N_active for MoE; the ratio MODEL_FLOPS / counted FLOPs exposes
the flash backward's recompute, remat and dispatch overheads.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict

from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.core.pytree import leaves
from repro_torch.kernels.pairwise_delta import M_ROWS

# NVIDIA H100 SXM5 80GB HBM3 (700 W) data sheet
HBM_BW = 3.35e12  # bytes/s
PEAK_BF16 = 989e12  # dense bf16 / fp16 tensor cores, FLOP/s
PEAK_TF32 = 495e12  # dense TF32 tensor cores
PEAK_F32 = 67e12  # f32 on the CUDA cores (no tensor cores)
LINK_BW = 450e9  # NVLink 4: 900 GB/s both ways, one direction
# FLOP/s by the kind of product: a dtype's name, or "tf32x3" (gram's three
# TF32 products a multiply-add, so its FLOP count at a third of TF32's)
PEAKS = {"bfloat16": PEAK_BF16, "float16": PEAK_BF16, "float32": PEAK_F32,
         "tf32x3": PEAK_TF32 / 3, "float64": PEAK_F32 / 2}


def peak(kind: str) -> float:
    """FLOP/s of a product kind (an unknown dtype counts at f32's)."""
    return PEAKS.get(kind, PEAK_F32)


# ------------------------------------------------------------- kernel work
@dataclasses.dataclass(frozen=True)
class Work:
    """What one kernel call must move and compute: each input read once,
    each output written once; FLOPs of the products of ``kind``."""
    bytes: float
    flops: float
    kind: str = "float32"
    # FLOPs with every masked (row, col) pair of attention computed, as
    # the reference's ``_attend`` computes full Sq × Sk products
    flops_full: float | None = None

    def bound(self):
        """(bound ms, "bytes" or "operations"): the larger of the two times."""
        t_bytes, t_ops = self.bytes / HBM_BW, self.flops / peak(self.kind)
        return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def gram_work(m: int, width: int, elem: int = 4, useful_width: int | None = None) -> Work:
    """G Gᵀ of (m, width) rows -> (m, m) f32: the upper triangle's
    m(m + 1)/2 dot products of ``useful_width`` columns (the rows' true
    width; ``width`` where None), in the arithmetic of the route the
    kernel's plan takes at m: f32 on the CUDA cores (kind ``float32``) at
    m <= M_ROWS, else three TF32 products a multiply-add (kind ``tf32x3``:
    a third of the TF32 peak)."""
    d = width if useful_width is None else useful_width
    return Work(elem * m * width + 4 * m * m, m * (m + 1) * d,
                "float32" if m <= M_ROWS else "tf32x3")


def mix_aggregate_work(k: int, m: int, d: int, elem: int = 4) -> Work:
    """W (k, m) f32 · θ (m, d) -> (k, d) in θ's dtype, ``elem`` bytes an
    element of θ and of the output; the sums in f32 on the CUDA cores."""
    return Work(4 * k * m + elem * (m * d + k * d), 2 * k * m * d)


def kmeans_assign_work(m: int, k: int, f: int) -> Work:
    """m points of width f against k centroids -> labels and distances."""
    return Work(4 * (m * f + k * f + 2 * m), 2 * m * k * f + 2 * (m + k) * f)


def cohort_gather_work(c: int, d: int, elem: int = 4, idx_elem: int = 4) -> Work:
    """c rows of width d copied out of the slab."""
    return Work(2 * elem * c * d + idx_elem * c, 0)


def masked_mix_scatter_work(c: int, d: int, real: int | None = None, elem: int = 4) -> Work:
    """The live slots' rows of W (c, c) · θ (c, d) written into the slab:
    ``real`` live slots (all c where None, as on the meta device, whose
    mask holds no values)."""
    r = c if real is None else real
    return Work(4 * r * c + elem * (c * d + r * d), 2 * r * c * d)


def attention_pairs(sq: int, sk: int, causal: bool) -> int:
    """(row, col) pairs the mask keeps: top-left causal keeps col <= row."""
    if not causal:
        return sq * sk
    full = min(sq, sk)  # rows 0 .. sk - 1 keep r + 1, the rest keep sk
    return full * (full + 1) // 2 + (sq - full) * sk


def flash_attention_work(b: int, hq: int, hkv: int, sq: int, sk: int, dh: int, causal: bool,
                         elem: int = 2) -> Work:
    """Online-softmax attention: q, k, v read once and out written once;
    two products (q·kᵀ and P·v) over the pairs the mask keeps (the useful
    half of a causal square), ``flops_full`` over all Sq × Sk pairs.
    bf16 (``elem`` 2) counts at the tensor cores' peak, f32 at the CUDA
    cores'."""
    nbytes = elem * (2 * b * hq * sq * dh + 2 * b * hkv * sk * dh)
    kind = "bfloat16" if elem == 2 else "float32"
    return Work(nbytes, 4 * b * hq * attention_pairs(sq, sk, causal) * dh, kind,
                flops_full=4 * b * hq * sq * sk * dh)


# ------------------------------------------------------------ model FLOPs
def param_count(abs_params) -> int:
    return sum(int(x.numel()) for x in leaves(abs_params))


def active_param_count(cfg: ModelConfig, total: int) -> int:
    """N_active: replace full expert FLOPs by top-k experts."""
    if cfg.moe_num_experts == 0:
        return total
    per_expert = 3 * cfg.d_model * (cfg.moe_d_ff or cfg.d_ff)
    moe_layers = cfg.num_layers - cfg.first_dense
    inactive = moe_layers * (cfg.moe_num_experts - cfg.moe_top_k) * per_expert
    return total - inactive


def model_flops(cfg: ModelConfig, shape: InputShape, n_active: int) -> float:
    """6·N·D for train, 2·N·D forward-only (prefill/decode)."""
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    tokens = shape.global_batch * 1  # decode: one token per request
    return 2.0 * n_active * tokens


# ------------------------------------------------------------ aggregation
@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    agg: str
    hlo_flops_per_chip: float  # counted FLOPs of one rank (aten products + kernels)
    hlo_bytes_per_chip: float  # counted bytes of one rank (unfused upper bound)
    collective_bytes_per_chip: float
    collectives: Dict[str, dict]
    model_flops_total: float
    param_count: int
    active_params: int
    memory_analysis: dict
    flops_by_kind: Dict[str, float] = dataclasses.field(default_factory=dict)
    kernel_calls: Dict[str, int] = dataclasses.field(default_factory=dict)

    @property
    def compute_s(self):
        return sum(f / peak(k) for k, f in self.flops_by_kind.items())

    @property
    def memory_s(self):
        return self.hlo_bytes_per_chip / HBM_BW

    @property
    def collective_s(self):
        return self.collective_bytes_per_chip / LINK_BW

    @property
    def dominant(self):
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def bound_s(self):
        """The largest of the three terms: no step can take less."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_ratio(self):
        total = self.hlo_flops_per_chip * self.chips
        return self.model_flops_total / total if total else 0.0

    def mfu(self, wall_s: float) -> float:
        """The counted FLOPs over the wall times each kind's peak."""
        return self.compute_s / wall_s

    def to_dict(self):
        d = dataclasses.asdict(self)
        d.update(
            compute_s=self.compute_s, memory_s=self.memory_s,
            collective_s=self.collective_s, dominant=self.dominant,
            useful_flops_ratio=self.useful_flops_ratio,
        )
        return d


def analyze(counts, cfg: ModelConfig, shape: InputShape, *, mesh_name: str, chips: int, agg: str,
            abs_params_one) -> Roofline:
    """The roofline of one counted step: ``counts`` an
    :class:`repro_torch.launch.op_analysis.Analysis` (with its ``memory``
    filled by :func:`repro_torch.launch.dryrun.trace_one`), the parameter
    count from ``abs_params_one``, the unpadded one-model tree."""
    n = param_count(abs_params_one)
    na = active_param_count(cfg, n)
    return Roofline(
        arch=cfg.name, shape=shape.name, mesh=mesh_name, chips=chips, agg=agg,
        hlo_flops_per_chip=counts.dot_flops, hlo_bytes_per_chip=counts.hbm_bytes,
        collective_bytes_per_chip=float(counts.collective_bytes),
        collectives=dict(counts.collectives),
        model_flops_total=model_flops(cfg, shape, na), param_count=n, active_params=na,
        memory_analysis=dict(counts.memory), flops_by_kind=dict(counts.flops_by_kind),
        kernel_calls=dict(counts.kernel_calls),
    )


def save(path: str, roof: Roofline):
    with open(path, "w") as f:
        json.dump(roof.to_dict(), f, indent=2, default=str)


def fmt_row(r: Roofline) -> str:
    return (
        f"{r.arch:18s} {r.shape:12s} {r.mesh:6s} {r.agg:13s} "
        f"comp={r.compute_s*1e3:9.3f}ms mem={r.memory_s*1e3:9.3f}ms "
        f"coll={r.collective_s*1e3:9.3f}ms dom={r.dominant:10s} "
        f"useful={r.useful_flops_ratio:6.3f}"
    )
