"""The port's examples (``examples_torch/``) on the CPU: each script's
``main`` with ``--device cpu`` (they run on the card by default, which
a CPU-only torch build cannot: ``resolve_device`` raises), and what
each prints or returns held to the reference example's claims at this
size."""
from __future__ import annotations

import importlib.util
import math
from pathlib import Path

import pytest
import torch
from torch_parity import one_torch_thread  # noqa: F401

EXAMPLES = Path(__file__).resolve().parents[1] / "examples_torch"


@pytest.fixture(autouse=True)
def _one_thread(one_torch_thread):
    """One torch thread a test: the examples train on the CPU, and under
    the tier-1 run's workers torch's default thread count oversubscribes
    the cores (``torch_parity.one_torch_thread``)."""


def load(name):
    spec = importlib.util.spec_from_file_location(f"examples_torch_{name}", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", ["quickstart", "clustered_streams", "serve_personalized",
                                  "federated_llm"])
def test_example_defaults_to_the_card(name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        load(name).main([])


def test_quickstart_on_cpu(capsys):
    h = load("quickstart").main(["--device", "cpu", "--rounds", "4"])
    out = capsys.readouterr().out
    assert "collaboration matrix W" in out and "--> user-centric:" in out
    assert "--> fedavg:" in out and "uplink" in out and "two-tier (E=2, k=2)" in out
    assert "pareto selection (bias=2)" in out
    assert 0.0 <= h.final_worst <= h.final_avg <= 1.0


def test_clustered_streams_on_cpu(capsys):
    out = load("clustered_streams").main(["--device", "cpu", "--rounds", "4"])
    text = capsys.readouterr().out
    assert "silhouette sweep (Alg. 2):" in text and "<-- chosen" in text
    assert 1 in out and 12 in out
    # more streams cost more round time under the wireless model (§V-D)
    times = [rt for _, rt in (out[k] for k in sorted(out))]
    assert times == sorted(times)
    assert all(0.0 <= acc <= 1.0 for acc, _ in out.values())


def test_serve_personalized_on_cpu(capsys):
    tokens = load("serve_personalized").main(["--device", "cpu"])
    assert tuple(tokens.shape) == (2, 2, 12)
    assert bool(((tokens >= 0) & (tokens < 512)).all())
    assert "sample (client 0, request 0)" in capsys.readouterr().out


def test_federated_llm_on_cpu(capsys):
    loss = load("federated_llm").main(["--device", "cpu", "--rounds", "6"])
    assert math.isfinite(loss)
    text = capsys.readouterr().out
    assert "collaboration matrix W" in text and "done: final loss" in text
