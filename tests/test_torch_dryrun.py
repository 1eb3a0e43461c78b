"""The analysis tooling on the meta device against the reference's
(``repro_torch.launch.steps``' abstract helpers, ``roofline``,
``op_analysis``, ``dryrun``, ``attribute``, ``summarize``).

The reference runs once for the module, in one subprocess started by the
first test that needs it (its device count must be set before jax's
first use, and ``repro.launch.dryrun`` would force 512 host devices at
import): its abstract parameter counts for the ten archs at full width,
with and without a 16-client axis, ``input_specs`` and ``abstract_cache``
shapes and dtypes for every arch × ``INPUT_SHAPES`` entry,
``active_param_count`` and ``model_flops``, and ``lower_one`` +
``roofline.analyze`` at a (1, 1) mesh with Auto axes (jax 0.9's
``jax.make_mesh`` makes Explicit axes, under which its own
``tests/test_dryrun_small.py`` fails) for seven reduced combos. The
port's side runs meanwhile.

Dot FLOPs (reduced configs, ``InputShape("t", 64, 8, kind)``), port
against the reference's ``hlo_analysis``: the port's attention calls
counted over all Sq × Sk pairs (``dot_flops_full``: the reference's
``_attend`` computes the masked products too) and, for a prefill, the
read-out of the positions before the last added back (the port's prefill
step reads out the last position alone; the reference computes every
position's logits and keeps the last). Prefill and decode within 1 %;
train within 10 %: the port's flash backward recomputes the forward's two
products (its plain version's vector-Jacobian product), which the
reference's differentiated ``_attend`` does not (measured here: +2.8 % at
reduced stablelm and mixtral; remat is off in reduced configs).
"""
from __future__ import annotations

import contextlib
import functools
import gzip
import io
import json
import os
import resource
import subprocess
import sys
import tempfile
from pathlib import Path

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import configs
from repro_torch.configs.base import INPUT_SHAPES, InputShape
from repro_torch.core.pytree import leaves
from repro_torch.kernels import ops
from repro_torch.launch import attribute, dryrun, op_analysis, roofline, steps, summarize

ROOT = Path(__file__).resolve().parents[1]
ARCHS = sorted(configs.ARCHITECTURES)
DOT_COMBOS = [("stablelm-1.6b", "prefill"), ("stablelm-1.6b", "train"),
              ("whisper-large-v3", "prefill"), ("gemma2-9b", "decode"),
              ("zamba2-2.7b", "decode"), ("mamba2-1.3b", "train"), ("mixtral-8x7b", "train")]
SMALL = dict(seq=64, batch=8)

_REF = r"""
import os, sys, json
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=1"
import jax
jax.devices()  # lock one device before repro.launch.dryrun's import asks for 512
from jax.sharding import AxisType
sys.path[:0] = [{src!r}]
from repro import configs
from repro.configs.base import INPUT_SHAPES, InputShape
from repro.launch import dryrun, roofline, steps
out = {{"params": {{}}, "specs": {{}}, "caches": {{}}, "active": {{}}, "model_flops": {{}},
       "dots": {{}}}}
desc = lambda tree: [[list(x.shape), str(x.dtype)] for x in jax.tree.leaves(tree)]
for name in sorted(configs.ARCHITECTURES):
    cfg = configs.get(name)
    n = roofline.param_count(steps.abstract_params(cfg))
    out["params"][name] = [n, roofline.param_count(steps.abstract_params(cfg, n_clients=16))]
    na = out["active"][name] = roofline.active_param_count(cfg, n)
    for sname, shape in INPUT_SHAPES.items():
        out["model_flops"][name + "/" + sname] = roofline.model_flops(cfg, shape, na)
        for nc in (None, 16):
            key = f"{{name}}/{{sname}}/{{nc}}"
            try:
                out["specs"][key] = {{k: [list(v.shape), str(v.dtype)]
                                     for k, v in steps.input_specs(cfg, shape, n_clients=nc).items()}}
                out["caches"][key] = desc(steps.abstract_cache(cfg, shape, n_clients=nc))
            except AssertionError:
                out["specs"][key] = out["caches"][key] = None
mesh = jax.make_mesh((1, 1), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
for arch, kind in {combos!r}:
    cfg = configs.get(arch).reduced()
    shape = InputShape("t", {seq}, {batch}, kind)
    compiled, meta = dryrun.lower_one(cfg, shape, mesh, agg="user_centric")
    roof = roofline.analyze(compiled, cfg, shape, mesh_name="t", chips=1, agg="user_centric",
                            abs_params_one=meta["abs_params_one"])
    out["dots"][arch + "/" + kind] = roof.hlo_flops_per_chip
json.dump(out, open({path!r}, "w"))
"""

_RUN = {}


def _start():
    """Start the reference's subprocess once (the first caller)."""
    if "proc" not in _RUN:
        tmp = tempfile.mkdtemp()
        path = os.path.join(tmp, "ref.json")
        script = _REF.format(src=str(ROOT / "src"), combos=DOT_COMBOS, path=path, **SMALL)
        env = dict(os.environ, JAX_PLATFORMS="cpu")
        _RUN["path"] = path
        _RUN["proc"] = subprocess.Popen([sys.executable, "-c", script], env=env,
                                        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    return _RUN["proc"]


@functools.lru_cache(maxsize=None)
def reference():
    proc = _start()
    _, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, err[-3000:]
    with open(_RUN["path"]) as f:
        return json.load(f)


def _desc(tree):
    return [[list(x.shape), str(x.dtype).replace("torch.", "")] for x in leaves(tree)]


# ------------------------------------------------------------ the roofline
def test_work_functions_give_the_kernel_table_bounds():
    """roofline's work functions give PERF.md §6's bound column at the
    table's shapes (H100 data-sheet rates): gram (100, 47,616), the mix at
    k = 100, the mix-scatter at c = 50 (42 live slots), flash 7a and 7b."""
    _start()
    cases = [(roofline.gram_work(100, 47616, useful_width=47571), 0.00570, "bytes"),
             (roofline.mix_aggregate_work(100, 100, 47616), 0.0142, "operations"),
             (roofline.masked_mix_scatter_work(50, 47616, 42), 0.00523, "bytes"),
             (roofline.flash_attention_work(4, 28, 4, 1024, 1024, 128, True), 0.0304,
              "operations"),
             (roofline.flash_attention_work(4, 28, 4, 1, 160, 128, False), 0.000408, "bytes")]
    for work, want, by in cases:
        ms, got_by = work.bound()
        assert float(f"{ms:.3g}") == want and got_by == by, (work, ms, got_by)


@pytest.mark.parametrize("m,d,want", [(4, 616_599_552, 2.945), (2, 1_713_418_240, 4.09),
                                      (2, 3 * 2**30 + 1_004, 7.69), (4, 47_616, 0.000227)])
def test_gram_work_takes_the_route_kind(m, d, want):
    """At m <= M_ROWS gram's few-row route multiplies in f32 on the CUDA
    cores (kind ``float32``), above it in 3xTF32 (``tf32x3``); at the
    collaboration rounds' few rows the bytes set the bound either way
    (PERF.md rows 1b, 1f and the wide check)."""
    from repro_torch.kernels.pairwise_delta import M_ROWS
    work = roofline.gram_work(m, d)
    ms, by = work.bound()
    assert work.kind == "float32" and by == "bytes" and abs(ms - want) <= 2e-3 * want
    assert roofline.gram_work(M_ROWS, d).kind == "float32"
    assert roofline.gram_work(M_ROWS + 1, d).kind == "tf32x3"
    assert roofline.gram_work(512, 47_616).kind == "tf32x3"


@pytest.mark.parametrize("dtype,elem", [(torch.float32, 4), (torch.bfloat16, 2)])
def test_mix_stand_in_keeps_theta_dtype(dtype, elem):
    """The meta stand-in of the mix returns θ's dtype, as the kernel does,
    and counts ``mix_aggregate_work(k, m, d, elem)``: W's f32 floats, θ
    and the output at θ's element bytes; the f32 count as before."""
    w = torch.empty(2, 4, device="meta")
    theta = torch.empty(4, 1000, dtype=dtype, device="meta")
    with op_analysis.counting() as c:
        out = ops.mix_aggregate(w, theta)
    assert out.is_meta and out.dtype == dtype and tuple(out.shape) == (2, 1000)
    work = roofline.mix_aggregate_work(2, 4, 1000, elem)
    assert work.bytes == 4 * 8 + elem * (4 + 2) * 1000 and work.flops == 2 * 2 * 4 * 1000
    assert c.analysis.kernel_calls == {"mix_aggregate": 1}
    assert c.analysis.kernel_bytes == work.bytes and c.analysis.kernel_flops == work.flops
    f32 = roofline.mix_aggregate_work(100, 100, 47616)
    assert f32.bytes == 4 * 100 * 100 + 4 * 100 * 47616 + 4 * 100 * 47616


def test_h100_constants_are_the_data_sheet_figures():
    assert roofline.HBM_BW == 3.35e12 and roofline.PEAK_BF16 == 989e12
    assert roofline.PEAK_TF32 == 495e12 and roofline.PEAK_F32 == 67e12
    assert roofline.LINK_BW == 450e9
    assert roofline.peak("tf32x3") == 495e12 / 3 and roofline.peak("float32") == 67e12


@pytest.mark.parametrize("sq,sk", [(1, 160), (64, 64), (100, 260), (80, 20)])
def test_attention_pairs_match_a_count_row_by_row(sq, sk):
    assert roofline.attention_pairs(sq, sk, True) == sum(min(r + 1, sk) for r in range(sq))
    assert roofline.attention_pairs(sq, sk, False) == sq * sk


@pytest.mark.parametrize("size", [2, 4, 8])
@pytest.mark.parametrize("kind", op_analysis.COLLECTIVE_OPS)
def test_ring_accounting_matches_parse_collectives(kind, size):
    """The port's moved bytes of one collective equal the reference's
    ``parse_collectives`` on a synthesized HLO line of the same result and
    group size."""
    from repro.launch import roofline as ref_roofline
    groups = "{" + ",".join("{" + ",".join(str(g * size + i) for i in range(size)) + "}"
                            for g in range(2)) + "}"
    line = f"  %x.1 = bf16[128,1024]{{1,0}} {kind}(bf16[64,1024]{{1,0}} %p), replica_groups={groups}"
    got = ref_roofline.parse_collectives(line, total_chips=2 * size)[kind]
    res = 128 * 1024 * 2
    assert got["count"] == 1 and got["result_bytes"] == res
    assert op_analysis.ring_moved(kind, res, size) == pytest.approx(got["moved_bytes"], rel=0)


# ------------------------------------------------------------ abstract steps
def test_abstract_params_count_without_drawing():
    """Every arch's params on meta at full width: no draw, no storage off
    meta, kimi-k2's 1.02 T parameters included."""
    _start()
    for name in ARCHS:
        p = steps.abstract_params(configs.get(name))
        assert all(x.is_meta for x in leaves(p))
    assert roofline.param_count(steps.abstract_params(configs.get("kimi-k2-1t-a32b"))) > 1e12


def test_meta_run_allocates_nothing_off_meta():
    """A full-width count (qwen2-7b's 32k prefill at one client, 15 GB of
    params) creates no tensor off the meta device and does not grow the
    process's memory."""
    seen = []

    class Devices(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            seen.extend(t.device.type for t in op_analysis.tensors(out))
            return out

    before = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    with Devices():
        ana, _ = dryrun.trace_one(configs.get("qwen2-7b"), INPUT_SHAPES["prefill_32k"],
                                  dryrun.make_mesh("card"), agg="user_centric")
    grown_kb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss - before
    assert seen and set(seen) == {"meta"}
    assert grown_kb < 1_000_000
    assert ana.memory["params_bytes"] == 2 * 7_615_616_512


def test_abstract_params_counts_equal_the_reference():
    ref = reference()
    for name in ARCHS:
        cfg = configs.get(name)
        n = roofline.param_count(steps.abstract_params(cfg))
        n16 = roofline.param_count(steps.abstract_params(cfg, n_clients=16))
        assert [n, n16] == ref["params"][name], name


def test_active_params_and_model_flops_equal_the_reference():
    ref = reference()
    for name in ARCHS:
        cfg = configs.get(name)
        na = roofline.active_param_count(cfg, roofline.param_count(steps.abstract_params(cfg)))
        assert na == ref["active"][name], name
        for sname, shape in INPUT_SHAPES.items():
            assert roofline.model_flops(cfg, shape, na) == ref["model_flops"][f"{name}/{sname}"]


@pytest.mark.parametrize("shape_name", list(INPUT_SHAPES))
def test_input_specs_and_caches_equal_the_reference(shape_name):
    """input_specs and abstract_cache shapes and dtypes, every arch, with no
    client axis and with 16 clients (where the batch divides; the
    reference asserts and the port raises ValueError where it does not)."""
    ref = reference()
    shape = INPUT_SHAPES[shape_name]
    for name in ARCHS:
        cfg = configs.get(name)
        for nc in (None, 16):
            key = f"{name}/{shape_name}/{nc}"
            if ref["specs"][key] is None:
                with pytest.raises(ValueError):
                    steps.input_specs(cfg, shape, n_clients=nc)
                continue
            got = {k: [list(v.shape), str(v.dtype).replace("torch.", "")]
                   for k, v in steps.input_specs(cfg, shape, n_clients=nc).items()}
            assert got == ref["specs"][key], key
            assert _desc(steps.abstract_cache(cfg, shape, n_clients=nc)) == ref["caches"][key], key


# ------------------------------------------------------------ op counts
def _counted(arch, kind, mesh="card"):
    cfg = configs.get(arch).reduced()
    return cfg, dryrun.trace_one(cfg, InputShape("t", SMALL["seq"], SMALL["batch"], kind),
                                 dryrun.make_mesh(mesh), agg="user_centric")[0]


@pytest.mark.parametrize("arch,kind", DOT_COMBOS)
def test_dot_flops_match_hlo_analysis(arch, kind):
    """Counted FLOPs at a (1, 1) mesh against the reference's hlo_analysis
    dot FLOPs (see the module docstring for the two conventions)."""
    _start()
    cfg, ana = _counted(arch, kind)
    port = ana.dot_flops_full
    if kind == "prefill":  # the read-out of positions 0 .. S - 2
        port += 2 * SMALL["batch"] * (SMALL["seq"] - 1) * cfg.d_model * cfg.padded_vocab
    want = reference()["dots"][f"{arch}/{kind}"]
    assert port == pytest.approx(want, rel=0.10 if kind == "train" else 0.01), (port, want)


def test_kernel_calls_are_counted_once_each():
    """A reduced stablelm train step at one client: two attention calls
    (one a layer, remat off) and one mix a leaf, each counted by its work
    function; a plain version's ops are not counted."""
    _, ana = _counted("stablelm-1.6b", "train")
    cfg = configs.get("stablelm-1.6b").reduced()
    nleaves = len(leaves(steps.abstract_params(cfg)))
    assert ana.kernel_calls == {"flash_attention_fma": cfg.num_layers, "mix_aggregate": nleaves}
    assert ana.dot_flops == pytest.approx(ana.aten_flops + ana.kernel_flops, rel=0)
    work = roofline.flash_attention_work(8, 4, 2, 64, 64, 32, True, 4)
    flash = [r for r in ana.op_rows() if r["op"] == "flash_attention_fma"]
    assert sum(r["flops"] for r in flash) == cfg.num_layers * work.flops


def test_dry_mesh_train_collectives_equal_their_hand_sum():
    """The user_centric train step at a dry (4, 2) mesh: rank 0 holds one
    client and all-gathers every leaf's 4 rows (its storage dtype) and the
    4 losses: moved bytes > 0 and each all-gather's result · 3/4."""
    _start()
    cfg, ana = _counted("stablelm-1.6b", "train", "4x2")
    p = steps.abstract_params(cfg, n_clients=4)
    results = sum(x.numel() * x.element_size() for x in leaves(p)) + 4 * 4
    ag = ana.collectives["all-gather"]
    assert ag["count"] == len(leaves(p)) + 1
    assert ag["result_bytes"] == results
    assert ana.collective_bytes == ag["moved_bytes"] == results * 3 / 4 > 0


def test_dry_collectives_raise_outside_the_counter():
    from repro_torch.federated import mesh as mesh_lib
    from repro_torch.launch import mesh as meshlib
    view = meshlib.make_dry_mesh((4, 2), ("data", "model")).axis("data")
    assert isinstance(view.group, mesh_lib.DryGroup) and view.shards == 4
    with pytest.raises(RuntimeError):
        mesh_lib.all_gather_rows(torch.empty(2, 3, device="meta"), view)
    with op_analysis.counting():
        with pytest.raises(RuntimeError):
            mesh_lib.all_gather_rows(torch.zeros(2, 3), view)
        out = mesh_lib.all_gather_rows(torch.empty(2, 3, device="meta"), view)
    assert tuple(out.shape) == (8, 3)
    single = meshlib.make_production_mesh(dry=True)
    assert single.shape == {"data": 16, "model": 16} and single.clients().shards == 16


# ------------------------------------------------------------ the CLI
def test_dryrun_cli_writes_json_and_failed(tmp_path, capsys):
    _start()
    out = str(tmp_path)
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "stablelm-1.6b", "--shape", "decode_32k,long_500k", "--out", out])
    assert e.value.code == 0
    tag = "stablelm-1.6b__decode_32k__card__user_centric"
    d = json.loads((tmp_path / f"{tag}.json").read_text())
    for k in ("arch", "shape", "mesh", "chips", "agg", "hlo_flops_per_chip", "hlo_bytes_per_chip",
              "collective_bytes_per_chip", "collectives", "model_flops_total", "param_count",
              "active_params", "memory_analysis", "compute_s", "memory_s", "collective_s",
              "dominant", "useful_flops_ratio", "t_lower_s", "t_compile_s", "clients",
              "federated_step"):
        assert k in d, k
    assert d["kernel_calls"] == {"flash_attention_decode": 24}
    assert not (tmp_path / "stablelm-1.6b__long_500k__card__user_centric.json").exists()
    with gzip.open(tmp_path / f"{tag}.ops.json.gz", "rt") as f:
        assert json.load(f)["rows"]
    buf = io.StringIO()
    attribute.report(str(tmp_path / f"{tag}.ops.json.gz"), top=5, out=buf)
    assert "flash_attention_decode" in buf.getvalue() and "dot FLOPs" in buf.getvalue()
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "stablelm-1.6b", "--shape", "decode_32k", "--sharding", "fsdp",
                     "--out", out])
    assert e.value.code == 1
    failed = (tmp_path / f"{tag}__fsdp.FAILED").read_text()
    assert "NotImplementedError" in failed


def test_summarize_equals_the_reference_byte_for_byte(tmp_path):
    """The reference's three tables and the port's on the same JSON dir."""
    from repro.launch import summarize as ref_summarize
    for arch, shape, mesh in (("stablelm-1.6b", "decode_32k", "card"),
                              ("mamba2-1.3b", "long_500k", "card"),
                              ("qwen2-7b", "decode_32k", "2x2")):
        assert dryrun.run_combo(arch, shape, mesh, agg="user_centric", num_streams=4,
                                out_dir=str(tmp_path), skip_existing=False)
    base = summarize.load_dir(str(tmp_path))
    assert base == ref_summarize.load_dir(str(tmp_path))
    for port_fn, ref_fn, args in ((summarize.roofline_table, ref_summarize.roofline_table, (base,)),
                                  (summarize.dryrun_table, ref_summarize.dryrun_table, (base,)),
                                  (summarize.diff_table, ref_summarize.diff_table, (base, base))):
        got, want = io.StringIO(), io.StringIO()
        with contextlib.redirect_stdout(got):
            port_fn(*args)
        with contextlib.redirect_stdout(want):
            ref_fn(*args)
        assert got.getvalue() == want.getvalue() and got.getvalue()
    got = io.StringIO()
    with contextlib.redirect_stdout(got):
        summarize.memory_table(base)
    assert got.getvalue().count("\n") == 2 + len(base)
