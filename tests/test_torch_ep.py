"""Expert parallelism over a 2-D rank mesh on the CPU: the port's
``moe.apply_expert_parallel`` in gloo ranks against the reference's
``shard_map`` path on forced host devices, the fedsgd step under expert
parallelism and the client-sharded train step against their one-rank
counterparts, and the rank mesh itself.

The reference runs once for the module, in one subprocess (the device
count must be forced before jax's import): meshes (2, 2) and (2, 1) of
("data", "model") and (2, 2, 1) of ("pod", "data", "model"), each built
with Auto axes (jax 0.9's ``jax.make_mesh`` defaults to Explicit axes,
under which the reference's own ``tests/test_moe_ep.py`` fails before its
EP code runs). It writes y, aux and the gradients to an ``.npz``. The
port's ranks run in one ``mesh.spawn`` per mesh shape, from the same
numpy inputs, while the reference computes.

The small MoE is the reference test's (d 32, d_ff 64, E 8, top-2), its
router biased towards experts 0 and 1 (both on data rank 0), so both
capacities drop at capacity factor 1.25 / cf2 1.5. Tolerances (f32, sums
in another order): y atol 1e-5, and the same drops at both stages as the
reference's bucketing (recomputed here in numpy from its routing); at
cf = cf2 = 8 nothing drops and y is within 1e-4 of the reference's
O(E·N) oracle; gradients of Σ y·r + aux with respect to every MoE leaf
and x within 1e-5 of each leaf's largest; aux atol 1e-6; in bf16, y within
one bf16 step of the reference's (``test_ep_bf16_matches_reference``). The fedsgd step
under expert parallelism (reduced kimi-k2, f32, capacity factor 8) and
the client-sharded step (reduced stablelm, 4 clients over 2 ranks, each
agg) within 1e-6 of the one-rank step on every leaf and on the loss: the
local batch shape changes the products' algorithms (ROADMAP C2 *Mesh*).
On the pod mesh the aux loss is each pod's own (the mean over its data
ranks, as the reference's ``pmean``), so the one-rank side is the mean of
the steps on each pod's half of the batch (momentum 0: plain SGD).
"""
import functools
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_mesh_ranks as ranks
from repro_torch.core.pytree import leaves, tree_map
from repro_torch.federated import mesh as mesh_lib
from repro_torch.launch import mesh as rank_mesh
from repro_torch.launch import sharding, steps
from repro_torch.models import moe

ROOT = Path(__file__).resolve().parents[1]
MESHES = {"2x2": ((2, 2), ("data", "model")), "2x1": ((2, 1), ("data", "model")),
          "pod2x2x1": ((2, 2, 1), ("pod", "data", "model"))}
B, S = 8, 16
STEP_TOL = dict(rtol=0, atol=1e-6)

_REF = r"""
import sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import AxisType
sys.path[:0] = [{src!r}]
from repro.models import moe
inp = np.load({inp!r})
p = {{k: jnp.asarray(inp[k]) for k in ("router", "w_gate", "w_up", "w_down")}}
x, r = jnp.asarray(inp["x"]), jnp.asarray(inp["r"])
kw = {kw!r}
out = {{}}
for tag, (shape, names) in {meshes!r}.items():
    mesh = jax.make_mesh(shape, names, axis_types=(AxisType.Auto,) * len(shape))
    moe.set_ep_mesh(mesh)
    for cf, cf2 in ((1.25, 1.5), (8.0, 8.0)):
        cfg = moe.MoEConfig(**kw, capacity_factor=cf, ep_axis="data")
        ep = lambda p, x, cfg=cfg, cf2=cf2: moe.apply_expert_parallel(p, x, cfg, cf2=cf2)
        y, aux = jax.jit(ep)(p, x)
        out[f"{{tag}}_y_{{cf}}"], out[f"{{tag}}_aux_{{cf}}"] = np.asarray(y), np.asarray(aux)
        if cf == 1.25:
            obj = lambda p, x, ep=ep: (lambda ya: (ya[0] * r).sum() + ya[1])(ep(p, x))
            gp, gx = jax.jit(jax.grad(obj, argnums=(0, 1)))(p, x)
            out.update({{f"{{tag}}_g_{{k}}": np.asarray(v) for k, v in gp.items()}})
            out[f"{{tag}}_g_x"] = np.asarray(gx)
    cfg = moe.MoEConfig(**kw, capacity_factor=1.25, ep_axis="data")
    pb = {{k: v if k == "router" else v.astype(jnp.bfloat16) for k, v in p.items()}}
    y, _ = jax.jit(lambda p, x: moe.apply_expert_parallel(p, x, cfg, cf2=1.5))(
        pb, x.astype(jnp.bfloat16))
    out[f"{{tag}}_y_bf16"] = np.asarray(y.astype(jnp.float32))
moe.set_ep_mesh(None)
cfg = moe.MoEConfig(**kw)
out["oracle"] = np.asarray(jax.jit(lambda p, x: moe.apply_reference(p, x, cfg))(p, x))
probs = jax.nn.softmax(x.reshape(-1, x.shape[-1]) @ p["router"], axis=-1)
out["top_ids"] = np.asarray(jax.lax.top_k(probs, cfg.top_k)[1])
np.savez({path!r}, **out)
"""


def _inputs(path):
    """The small MoE's weights and tokens, the router biased so that
    experts 0 and 1 take most tokens, and the cotangent r."""
    rng = np.random.default_rng(0)
    d, f, e = ranks.EP_MOE["d_model"], ranks.EP_MOE["d_ff"], ranks.EP_MOE["num_experts"]
    router = rng.normal(size=(d, e)) * 3 / d ** 0.5
    router[0, :2] += (2.5, 2.0)
    x = rng.normal(size=(B, S, d))
    x[..., 0] += 2.5
    arrays = {"router": router, "w_gate": rng.normal(size=(e, d, f)) / d ** 0.5,
              "w_up": rng.normal(size=(e, d, f)) / d ** 0.5,
              "w_down": rng.normal(size=(e, f, d)) / f ** 0.5, "x": x,
              "r": rng.normal(size=(B, S, d))}
    np.savez(path, **{k: v.astype(np.float32) for k, v in arrays.items()})
    return dict(np.load(path))


@functools.lru_cache(maxsize=None)
def runs():
    """({mesh tag: [each rank's report]}, the reference's arrays, the inputs)."""
    with tempfile.TemporaryDirectory() as tmp:
        inp = _inputs(f"{tmp}/inp.npz")
        script = _REF.format(src=str(ROOT / "src"), inp=f"{tmp}/inp.npz", kw=ranks.EP_MOE,
                             meshes=MESHES, path=f"{tmp}/ref.npz")
        env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
                   JAX_PLATFORMS="cpu")
        ref = subprocess.Popen([sys.executable, "-c", script], env=env, cwd=tmp)
        try:
            reports = {tag: mesh_lib.spawn(ranks.ep_rank, int(np.prod(shape)),
                                           store_path=f"{tmp}/store_{tag}", timeout=240,
                                           args=(shape, names, f"{tmp}/inp.npz"))
                       for tag, (shape, names) in MESHES.items()}
        finally:
            assert ref.wait(timeout=300) == 0
        want = dict(np.load(f"{tmp}/ref.npz"))
    return reports, want, inp


def _slice(tag, rep):
    """The batch rows of a rank's report."""
    pods = MESHES[tag][0][0] if len(MESHES[tag][0]) == 3 else 1
    data = MESHES[tag][0][-2]
    c = rep["coords"].get("pod", 0) * data + rep["coords"]["data"]
    b = B // (pods * data)
    return slice(c * b, (c + 1) * b)


def _drops(top_ids, tag, cf=1.25, cf2=1.5):
    """The reference's drops recomputed in numpy from its routing: {(pod,
    data): (assignments dropped at cap by that source, rows dropped at
    cap2 by that owner)}: the stable bucketing by owner, the exchange in
    (source rank, slot) order, the stable grouping by local expert."""
    shape = MESHES[tag][0]
    pods, data = (shape[0], shape[1]) if len(shape) == 3 else (1, shape[0])
    e, k = ranks.EP_MOE["num_experts"], ranks.EP_MOE["top_k"]
    e_loc = e // data
    ids = top_ids.reshape(B, S, k)
    n = B // (pods * data) * S
    cap = max(int(k * n * cf / data) - int(k * n * cf / data) % -8, 8)
    c2 = min(int(data * cap * cf2 / e_loc), data * cap)
    cap2 = max(c2 - c2 % -8, 8)
    out = {}
    for p in range(pods):
        sent = {}  # (source, owner) -> the local experts of the kept rows, in slot order
        for d in range(data):
            rows = ids[(p * data + d) * (n // S):(p * data + d + 1) * (n // S)].reshape(-1)
            dropped = 0
            for o in range(data):
                mine = [int(i) % e_loc for i in rows if int(i) // e_loc == o]
                sent[d, o] = mine[:cap]
                dropped += max(len(mine) - cap, 0)
            out[p, d] = [dropped, 0]
        for o in range(data):
            got = [x for d in range(data) for x in sent[d, o]]
            out[p, o][1] = sum(max(got.count(j) - cap2, 0) for j in range(e_loc))
    return out


@pytest.mark.parametrize("tag", list(MESHES))
def test_ep_matches_reference_with_drops(tag):
    reports, want, _ = runs()
    drops = _drops(want["top_ids"], tag)
    assert sum(a for a, _ in drops.values()) > 0 and sum(b for _, b in drops.values()) > 0
    for rep in reports[tag]:
        sl = _slice(tag, rep)
        np.testing.assert_allclose(rep["y"], want[f"{tag}_y_1.25"][sl], rtol=0, atol=1e-5)
        assert [rep["at_cap"], rep["at_cap2"]] == drops[rep["coords"].get("pod", 0),
                                                        rep["coords"]["data"]]
        if rep["coords"].get("pod", 0) == 0:  # the reference's aux: pod 0's data mean
            np.testing.assert_allclose(rep["aux"], want[f"{tag}_aux_1.25"], rtol=0, atol=1e-6)
    # the drops matter: the oracle is far from y where they happen
    assert float(np.abs(want[f"{tag}_y_1.25"] - want["oracle"]).max()) > 1e-2


@pytest.mark.parametrize("tag", list(MESHES))
def test_ep_bf16_matches_reference(tag):
    """bf16 weights and tokens (the router f32) at cf 1.25 / cf2 1.5: y
    against the reference's bf16 ``shard_map`` output. Both keep the gate
    and up products and the activation in f32 and round the activation,
    the F-shard rows, their SUM and y to bf16; the sums' orders differ, so
    an element may round to the neighbouring bf16 value: within one bf16
    step (2^-8 of its magnitude, atol 2^-8 of the largest) everywhere, and
    bit for bit on at least 95 % of the elements (all of them here).
    Rounding the gate and up products to bf16 as well changes about half
    of them."""
    reports, want, _ = runs()
    for rep in reports[tag]:
        got, exp = rep["y_bf16"], want[f"{tag}_y_bf16"][_slice(tag, rep)]
        assert np.all(np.abs(got - exp) <= 2.0 ** -8 * (np.abs(exp) + np.abs(exp).max()))
        assert float(np.mean(got != exp)) <= 0.05


@pytest.mark.parametrize("tag", list(MESHES))
def test_ep_matches_oracle_without_drops(tag):
    reports, want, _ = runs()
    for rep in reports[tag]:
        assert rep["drops8"] == [0, 0]
        np.testing.assert_allclose(rep["y8"], want["oracle"][_slice(tag, rep)], rtol=0,
                                   atol=1e-4)
        np.testing.assert_allclose(rep["y8"], want[f"{tag}_y_8.0"][_slice(tag, rep)], rtol=0,
                                   atol=1e-5)


@pytest.mark.parametrize("tag", list(MESHES))
def test_ep_folds_two_clients(tag):
    """m = 2 clients on the mesh (the second client's experts and tokens
    others): at cf = cf2 = 8 each client's y within 1e-5 of the port's sort
    dispatch on the whole experts; aux, the mean over every data rank's
    tokens, against the sort dispatch's over the whole batch (one pod)."""
    reports, _, _ = runs()
    for rep in reports[tag]:
        assert rep["y2_err"] <= 1e-5
        if not tag.startswith("pod"):
            assert rep["aux2_err"] <= 1e-6


@pytest.mark.parametrize("tag", list(MESHES))
def test_ep_gradients_match_reference(tag):
    """Each rank's gradients assembled into the whole leaves: the router's
    summed over the client ranks (each "model" rank holds the same one),
    each expert block in its place (summed over the pods, whose ranks hold
    replicas), x's slices; every "model" rank holds x's whole gradient."""
    reports, want, inp = runs()
    shape = MESHES[tag][0]
    data, model = shape[-2], shape[-1]
    e, f = ranks.EP_MOE["num_experts"], ranks.EP_MOE["d_ff"]
    el, fl = e // data, f // model
    got = {k: np.zeros_like(inp[k]) for k in ("router", "w_gate", "w_up", "w_down", "x")}
    for rep in reports[tag]:
        d, j = rep["coords"]["data"], rep["coords"]["model"]
        if j == 0:
            got["router"] += rep["g_router"]
            got["x"][_slice(tag, rep)] = rep["gx"]
        else:
            twin = next(o for o in reports[tag] if o["coords"] == dict(rep["coords"], model=0))
            np.testing.assert_allclose(rep["gx"], twin["gx"], rtol=0, atol=1e-6)
        got["w_gate"][d * el:(d + 1) * el, :, j * fl:(j + 1) * fl] += rep["g_w_gate"]
        got["w_up"][d * el:(d + 1) * el, :, j * fl:(j + 1) * fl] += rep["g_w_up"]
        got["w_down"][d * el:(d + 1) * el, j * fl:(j + 1) * fl] += rep["g_w_down"]
    for k, g in got.items():
        w = want[f"{tag}_g_{k}"]
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5 * float(np.abs(w).max()), err_msg=k)


@functools.lru_cache(maxsize=None)
def one_rank_fedsgd(pods=1):
    """The one-rank fedsgd step; over ``pods`` pods the mean of the steps
    on each pod's contiguous part of the batch (momentum 0: plain SGD),
    since the aux loss is each pod's own (its data ranks' mean)."""
    cfg = ranks.ep_train_config()
    params = sharding.rank_params(cfg, ranks.EP_SEED, None, "cpu")
    batch = ranks.ep_train_batch(cfg)
    rows = batch["tokens"].shape[0] // pods
    news, losses = [], []
    for p in range(pods):
        part = {k: v[p * rows:(p + 1) * rows] for k, v in batch.items()}
        new, _, met = ranks.ep_fedsgd_step(cfg, params, part)
        news.append(new)
        losses.append(float(met["loss"]))
    return cfg, tree_map(lambda *xs: sum(xs) / pods, *news), sum(losses) / pods


@pytest.mark.parametrize("tag", list(MESHES))
def test_ep_fedsgd_step_matches_one_rank(tag):
    """The fedsgd step under expert parallelism: each rank's new params
    (its expert blocks, the rest whole) and the loss metric against the
    one-rank step on the whole batch and model (over pods: the mean of the
    pods' steps); the exchange ran."""
    reports, _, _ = runs()
    cfg, new, loss = one_rank_fedsgd(2 if tag.startswith("pod") else 1)
    for rep in reports[tag]:
        mesh = _FakeMesh(MESHES[tag], rep["coords"])
        want = [x.numpy() for x in leaves(sharding.rank_block(new, cfg, mesh))]
        assert len(rep["step"]) == len(want)
        for g, w in zip(rep["step"], want):
            np.testing.assert_allclose(g, w, **STEP_TOL)
        np.testing.assert_allclose(rep["step_loss"], loss, **STEP_TOL)
        assert rep["collectives"].get("all_to_all", 0) > 0 and rep["collectives"]["axis_mean"] > 0


class _FakeMesh:
    """A rank's shape and coordinates, for ``sharding``'s block bounds."""

    def __init__(self, spec, coords):
        self.shape = dict(zip(spec[1], spec[0]))
        self.coords = coords


@pytest.mark.parametrize("tag", list(MESHES))
def test_serve_on_the_mesh_matches_one_rank(tag):
    """``serve(mesh=)``: each rank's slice of the requests, its experts
    sharded, gives the one-rank mesh's greedy tokens and last logits (a
    1 x 1 mesh: the whole model from the same seeds)."""
    reports, _, _ = runs()
    want = ranks.ep_serve(rank_mesh.make_host_mesh())
    per = 4 // (len(reports[tag]) // MESHES[tag][0][-1])
    for rep in reports[tag]:
        c = rep["coords"].get("pod", 0) * MESHES[tag][0][-2] + rep["coords"]["data"]
        np.testing.assert_array_equal(rep["served"]["tokens"],
                                      want.tokens[:, c * per:(c + 1) * per].numpy())
        np.testing.assert_allclose(rep["served"]["logits"],
                                   want.logits[:, c * per:(c + 1) * per].numpy(), rtol=0,
                                   atol=1e-4)


@functools.lru_cache(maxsize=None)
def unsharded_gather():
    cfg, params, batch, mixes = ranks.gather_task()
    return {agg: ranks.gather_step(cfg, agg, params, mix, batch) for agg, mix in mixes.items()}


@pytest.mark.parametrize("agg", steps.AGGS)
def test_client_sharded_train_step_matches_unsharded(agg):
    """``mix_gather_shardings`` over 2 ranks (the RankMesh, and for
    user_centric a ClientMesh): each rank's 2 client rows of params and
    the loss over all 4 clients against the unsharded step."""
    reports, _, _ = runs()
    new, _, met = unsharded_gather()[agg]
    for rep in reports["2x1"]:
        lo = rep["coords"]["data"] * 2
        want = [x.numpy()[lo:lo + 2] for x in leaves(new)]
        for name in ("rank_mesh", "client_mesh"):
            got = rep.get(f"gather_{agg}_{name}")
            if got is None:
                assert name == "client_mesh" and agg != "user_centric"
                continue
            for g, w in zip(got["params"], want):
                np.testing.assert_allclose(g, w, **STEP_TOL)
            np.testing.assert_allclose(got["loss"], float(met["loss"]), **STEP_TOL)


def test_mix_gather_shardings_refuses_other_placements():
    cfg = ranks.gather_task()[0]
    with pytest.raises(TypeError, match="takes the mesh that holds the clients"):
        steps.build_train_step(cfg, n_clients=2, agg="fedavg", mix_gather_shardings=object())


def test_one_rank_mesh_needs_no_process_group():
    """A 1 x 1 mesh runs without a group; its EP path is the local sort
    dispatch's arithmetic (nothing dropped), its collectives the identity;
    the helpers count as the reference's; a mesh the group cannot fill
    raises."""
    mesh = rank_mesh.make_host_mesh(data=4, model=2)
    assert mesh.shape == {"data": 1, "model": 1} and mesh.coords == {"data": 0, "model": 0}
    assert rank_mesh.client_axes(mesh) == ("data",) and rank_mesh.num_clients(mesh) == 1
    assert rank_mesh.num_chips(mesh) == 1 and mesh.clients().group is None
    with pytest.raises(ValueError, match="every rank of the group"):
        rank_mesh.make_production_mesh()
    with pytest.raises(ValueError, match="every rank of the group"):
        rank_mesh.make_production_mesh(multi_pod=True)
    cfg = moe.MoEConfig(**ranks.EP_MOE, capacity_factor=8.0, ep_axis="data")
    gen = torch.Generator().manual_seed(0)
    p = {k: v[None] for k, v in moe.init(gen, cfg, torch.float32, "cpu").items()}
    x = torch.randn(1, 2, 8, cfg.d_model, generator=gen)
    t = torch.ones(3)
    assert mesh_lib.all_to_all(t, mesh.axis("data")) is t
    moe.set_ep_mesh(mesh)
    try:
        assert moe.ep_mesh() is mesh
        y, aux = moe.apply_auto(p, x, cfg)
        drops = moe.ep_dropped(p, x, cfg, cf2=8.0)
    finally:
        moe.set_ep_mesh(None)
    want_y, want_aux = moe.apply(p, x, cfg)
    np.testing.assert_allclose(y.numpy(), want_y.numpy(), rtol=0, atol=1e-6)
    np.testing.assert_allclose(aux.numpy(), want_aux.numpy(), rtol=0, atol=1e-7)
    assert [int(d.sum()) for d in drops] == [0, 0, 0]
    with pytest.raises(ValueError, match="set_ep_mesh"):
        moe.apply_expert_parallel(p, x, cfg)


def test_rank_params_blocks_make_up_the_whole_model():
    """sharding.rank_params at every position of a (2, 2) mesh holds the
    whole model's blocks (``rank_block``), bit for bit: the experts come
    from their own seeds, every other leaf from the shared generator; and
    every rank of each mesh gathers its blocks (``gather_blocks``) back
    into that whole model."""
    cfg = ranks.ep_train_config()
    whole = sharding.rank_params(cfg, 3, None, "cpu")
    for d in range(2):
        for j in range(2):
            mesh = _FakeMesh(MESHES["2x2"], {"data": d, "model": j})
            got = sharding.rank_params(cfg, 3, mesh, "cpu")
            want = sharding.rank_block(whole, cfg, mesh)
            assert all(torch.equal(a, b) for a, b in zip(leaves(got), leaves(want)))
            w_gate = got["blocks"]["l0"]["moe"]["w_gate"]
            assert tuple(w_gate.shape[-3:]) == (cfg.moe_num_experts // 2, cfg.d_model,
                                                cfg.moe_d_ff // 2)
    assert tree_map(lambda x: x.shape, whole)["blocks"]["l0"]["moe"]["w_gate"][-3] == 4
    want = [x.numpy() for x in leaves(sharding.rank_params(cfg, ranks.EP_SEED, None, "cpu"))]
    for reports in runs()[0].values():
        for rep in reports:
            assert len(rep["gathered"]) == len(want)
            assert all(np.array_equal(a, b) for a, b in zip(rep["gathered"], want))
