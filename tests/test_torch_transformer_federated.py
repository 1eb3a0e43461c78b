"""Federated fine-tuning of a small multi-leaf transformer on the port's slab
engine (``tests/test_transformer_federated.py`` on ``repro_torch``).

"Any apply_fn, one slab": a strategy sees a model's tree only at the apply
boundary, so a transformer runs through the cohort engine as LeNet does,
raveled once (nested dicts, the reference's leaf order) into one
``(m, d_aligned)`` float32 slab and mixed by ``masked_mix_scatter``. The
model is reduced qwen2-7b (2 layers, d_model 128, vocab 512, the
reference's init), with last-token class logits as ``apply_stacked``;
labels are the last token mod C. Three cohort rounds must bring the mean
training loss below half its start, and the int8 uplink composes. Two
more tests hold the transformer's slab layout against the reference's and
run the strategy through ``simulation.run``.
"""
import functools

import jax
import numpy as np
import torch
import torch.nn.functional as F

from repro import configs as ref_configs
from repro.core import flat as ref_flat
from repro.models import transformer as ref_transformer
from repro_torch import configs, interop
from repro_torch.core import FedConfig, flat, ucfl
from repro_torch.data.synthetic import FederatedData
from repro_torch.federated import simulation
from repro_torch.federated.transport import TransportConfig
from repro_torch.kernels import ops
from repro_torch.models import transformer
from torch_parity import n, np_tree

NUM_CLASSES = 8


@functools.lru_cache(maxsize=1)
def _setup():
    cfg = configs.get("qwen2-7b").reduced()
    rcfg = ref_configs.get("qwen2-7b").reduced()

    def apply_stacked(params, x):
        return transformer.forward(params, {"tokens": x}, cfg)[..., -1, :NUM_CLASSES]

    p0 = np_tree(jax.jit(functools.partial(ref_transformer.init, cfg=rcfg))(
        jax.random.PRNGKey(0)))
    params0 = interop.transformer_params_from_numpy(p0, device="cpu")
    m, nn, seq = 4, 24, 8
    toks = np.random.default_rng(0).integers(1, cfg.vocab_size, size=(m, nn + 8, seq))
    toks = torch.as_tensor(toks, dtype=torch.int64)
    y = toks[..., -1] % NUM_CLASSES
    data = FederatedData(x=toks[:, :nn], y=y[:, :nn], x_test=toks[:, nn:], y_test=y[:, nn:],
                         group=torch.zeros(m, dtype=torch.int64),
                         n=torch.full((m,), nn, dtype=torch.int64))
    return apply_stacked, params0, p0, data


def _mean_train_loss(strat, apply_stacked, state, data):
    with torch.no_grad():
        logits = apply_stacked(strat.eval_params(state), data.x)
        return float(F.cross_entropy(logits.reshape(-1, NUM_CLASSES), data.y.reshape(-1)))


def _run(transport=None, rounds=3):
    apply_stacked, params0, _, data = _setup()
    fcfg = FedConfig(lr=0.05, momentum=0.9, epochs=1, batch_size=12, transport=transport)
    strat = ucfl.make_ucfl(apply_stacked, params0, fcfg, var_batch_size=12, device="cpu")
    state = strat.init(torch.Generator().manual_seed(1), data)
    cohort = np.arange(data.y.shape[0], dtype=np.int32)
    gen = torch.Generator().manual_seed(2)
    loss0 = _mean_train_loss(strat, apply_stacked, state, data)
    for _ in range(rounds):
        state, _ = strat.round(state, data, gen, cohort)
    return strat, apply_stacked, state, data, loss0


def test_transformer_trains_on_flat_slab_fused_path(monkeypatch):
    calls = []
    real = ops.masked_mix_scatter
    monkeypatch.setattr(ops, "masked_mix_scatter",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    strat, apply_stacked, state, data, loss0 = _run()
    slab = state["params"]
    assert slab.dim() == 2 and slab.shape[0] == data.y.shape[0]
    assert slab.dtype == torch.float32 and slab.shape[1] % ops.ALIGN == 0
    loss1 = _mean_train_loss(strat, apply_stacked, state, data)
    assert len(calls) == 3  # one fused mix-scatter a cohort round
    assert loss1 < 0.5 * loss0, (loss0, loss1)


def test_transformer_int8_transport_composes():
    strat, apply_stacked, state, data, _ = _run(TransportConfig("int8"), rounds=2)
    assert "ef" in state and state["ef"].shape == state["params"].shape
    assert float(state["ef"].abs().max()) > 0.0
    assert bool(torch.isfinite(state["params"]).all())
    assert np.isfinite(_mean_train_loss(strat, apply_stacked, state, data))


def test_transformer_slab_layout_matches_reference():
    _, params0, p0, _ = _setup()
    rl = ref_flat.LayoutTable.build(jax.tree.map(jax.numpy.asarray, p0))
    tl = flat.LayoutTable.build(params0)
    assert tl.shapes == rl.shapes and tl.offsets == rl.offsets and tl.sizes == rl.sizes
    assert (tl.dim, tl.dim_aligned) == (rl.dim, rl.dim_aligned)
    assert tl.keys[0] == "blocks/l0/attn/bk" and len(tl.keys) == len(jax.tree.leaves(p0))
    slab = tl.slab(params0, 2)
    np.testing.assert_array_equal(n(slab), np.asarray(rl.slab(jax.tree.map(
        jax.numpy.asarray, p0), 2)))
    back = tl.unravel(slab)
    assert back.keys() == params0.keys()
    assert torch.equal(back["blocks"]["l0"]["attn"]["wq"][1], params0["blocks"]["l0"]["attn"]["wq"])


def test_transformer_strategy_runs_through_simulation_run():
    """``simulation.run`` over the transformer's nested-tree slab: the
    evaluation and the finite check walk the nested params, and two rounds
    lift the clients' last-token accuracy above the untrained model's."""
    apply_stacked, params0, _, data = _setup()
    fcfg = FedConfig(lr=0.05, momentum=0.9, epochs=1, batch_size=12)
    strat = ucfl.make_ucfl(apply_stacked, params0, fcfg, var_batch_size=12, device="cpu")
    hist = simulation.run(strat, apply_stacked, data, 0, rounds=2, device="cpu")
    assert len(hist.avg_acc) == 2 and np.isfinite(hist.avg_acc).all()
    untrained = float(simulation.evaluate(apply_stacked, strat.eval_params(
        strat.init(torch.Generator().manual_seed(0), data)), data.x_test, data.y_test).mean())
    assert hist.avg_acc[-1] > untrained, (hist.avg_acc, untrained)
