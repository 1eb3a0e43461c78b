"""The quantized wire (``repro_torch.federated.transport``) in both packages.

Bit for bit against the reference, run op by op as its own transport
tests run it (outside ``jax.jit``: compiled, XLA may turn the division by
the int8/fp8 range into a product with its reciprocal, which moves the
scale's last bit): ``quantize``, ``dequantize`` and ``roundtrip`` in int8
and fp8 at several shapes and chunks, ``make_stage``, and
``make_wire_stage`` on a mixed delta/raw/relay schema and on SCAFFOLD's
two-stream schema, each direction. Inputs come from a seed with numpy.

Then the properties of the reference's ``test_transport.py`` and
``test_wire_schema.py`` on the port: the int8 error bound (half a step of
max|chunk|/127) and the fp8 bound (max|chunk|/16); exact zeros on zero
chunks; error feedback telescoping per stream; config validation; the
chunk-mismatch message; no stage for a direction without a delta stream.
The residual check states its tolerance relative to the stream's
magnitude: ``carry − deq`` and ``delta − applied`` are the same residual
computed two ways in f32 (``applied = (pre + deq) − pre``), so they differ
by the f32 rounding of the stream's operands, a few ulp of max(|pre|,
|post|): 7.6e-6 at a magnitude of 100.
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.federated import transport as ref_transport
from repro_torch.federated import transport
from repro_torch.federated.transport import Stream, TransportConfig, WireSchema
from torch_parity import n, t

KINDS = ["int8", "fp8"]
INT8 = TransportConfig("int8")
FP8 = TransportConfig("fp8")

# odd, zero, raw, relay and delta widths: 100 -> 128, 0 -> 0, 130 -> 256
MIXED = WireSchema(
    "mixed",
    uplink=(Stream("a", 100), Stream("gap", 0), Stream("b", 130, coding="raw"),
            Stream("r", 40, coding="relay"), Stream("c", 130)),
    downlink=(Stream("d", 300), Stream("e", 60, coding="raw")),
)
SCAFFOLD = WireSchema(
    "scaffold",
    uplink=(Stream("delta", 300), Stream("control_delta", 300)),
    downlink=(Stream("model", 300), Stream("control", 300)),
)


def _ref_cfg(cfg):
    return ref_transport.TransportConfig(cfg.kind, cfg.chunk)


def _ref_schema(schema):
    def conv(streams):
        return tuple(ref_transport.Stream(s.name, s.width, s.coding) for s in streams)

    return ref_transport.WireSchema(schema.strategy, conv(schema.uplink), conv(schema.downlink))


def _inputs(shape, seed, *, tail=0):
    """f32 rows whose chunks span six decades of magnitude, the last
    ``tail`` columns zero (the slab's aligned tail)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape) * 10.0 ** rng.uniform(-3, 3, size=shape[:-1] + (1,))
    x = x.astype(np.float32)
    if tail:
        x[..., -tail:] = 0.0
    return x


def _chunk_steps(x, chunk):
    """Per-element max|chunk|, the shape of x."""
    x = np.asarray(x)
    xs = x.reshape(x.shape[:-1] + (-1, chunk))
    peak = np.abs(xs).max(-1, keepdims=True)
    return np.broadcast_to(peak, xs.shape).reshape(x.shape)


# ------------------------------------------------------ bits vs reference

@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("shape,chunk", [((256,), 128), ((3, 256), 128), ((2, 3, 128), 32),
                                         ((4, 384), 64), ((50, 47616), 128)])
def test_quantize_roundtrip_bits_match_reference(kind, shape, chunk):
    x = _inputs(shape, seed=sum(shape) + chunk, tail=64 if shape[-1] > 256 else 0)
    cfg = TransportConfig(kind, chunk)
    q, scale = transport.quantize(t(x), cfg)
    rq, rscale = ref_transport.quantize(jnp.asarray(x), _ref_cfg(cfg))
    assert q.dtype == (torch.int8 if kind == "int8" else torch.float8_e4m3fn)
    assert tuple(q.shape) == tuple(rq.shape) and tuple(scale.shape) == tuple(rscale.shape)
    np.testing.assert_array_equal(n(q.to(torch.float32)), np.asarray(rq.astype(jnp.float32)))
    np.testing.assert_array_equal(n(scale), np.asarray(rscale))
    np.testing.assert_array_equal(n(transport.dequantize(q, scale)),
                                  np.asarray(ref_transport.dequantize(rq, rscale)))
    np.testing.assert_array_equal(n(transport.roundtrip(t(x), cfg)),
                                  np.asarray(ref_transport.roundtrip(jnp.asarray(x),
                                                                     _ref_cfg(cfg))))


def test_fp8_cast_is_correctly_rounded():
    """The port's e4m3 cast is ``ml_dtypes``'s correctly rounded one. The
    reference's compiled cast, where it feeds a product, rounds through
    f16 instead, yet stays within one e4m3 step of it."""
    x = _inputs((5, 15360), seed=9)
    q, scale = transport.quantize(t(x), FP8)
    v = x.reshape(5, -1, 128) / n(scale)
    np.testing.assert_array_equal(n(q.to(torch.float32)),
                                  v.astype(ml_dtypes.float8_e4m3fn).astype(np.float32))
    w = np.full((1, 5), 0.2, np.float32)
    mean = jax.jit(lambda a, b: b @ ref_transport.roundtrip(a, _ref_cfg(FP8)))(
        jnp.asarray(x), jnp.asarray(w))
    got = w @ n(transport.roundtrip(t(x), FP8))
    step = (_chunk_steps(x, 128) * 32.0 / 448.0).max(axis=0)  # e4m3's step at a chunk's top
    # a mean of 5 rows, each within a step
    assert (np.abs(np.asarray(mean) - got) <= step + 1e-6).all()


def _stage_inputs(rows, width, seed):
    rng = np.random.default_rng(seed)
    pre = rng.normal(size=(rows, width)).astype(np.float32)
    post = (pre + 0.05 * rng.normal(size=(rows, width))).astype(np.float32)
    ef = (1e-3 * rng.normal(size=(rows, width))).astype(np.float32)
    return pre, post, ef


def _assert_stage_bits(stage, ref_stage, rows, width, seed):
    pre, post, ef = _stage_inputs(rows, width, seed)
    for step in range(2):  # the second call carries the first call's EF
        got = stage(t(pre), t(post), t(ef))
        want = ref_stage(jnp.asarray(pre), jnp.asarray(post), jnp.asarray(ef))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(n(g), np.asarray(w), err_msg=f"call {step}")
        pre, post, ef = n(got[0]), (n(got[0]) + 0.05).astype(np.float32), n(got[1])


@pytest.mark.parametrize("kind", KINDS)
def test_make_stage_bits_match_reference(kind):
    cfg = TransportConfig(kind)
    _assert_stage_bits(transport.make_stage(cfg), ref_transport.make_stage(_ref_cfg(cfg)),
                       5, 384, seed=3)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("schema", [MIXED, SCAFFOLD], ids=["mixed", "scaffold"])
@pytest.mark.parametrize("direction", ["uplink", "downlink"])
def test_make_wire_stage_bits_match_reference(kind, schema, direction):
    cfg = TransportConfig(kind)
    stage = transport.make_wire_stage(schema, cfg, direction)
    ref_stage = ref_transport.make_wire_stage(_ref_schema(schema), _ref_cfg(cfg), direction)
    assert (stage is None) == (ref_stage is None) and stage is not None
    _assert_stage_bits(stage, ref_stage, 4, schema.width_aligned(direction), seed=5)


def test_schema_geometry_matches_reference():
    for schema in (MIXED, SCAFFOLD):
        ref = _ref_schema(schema)
        for direction in ("uplink", "downlink"):
            assert schema.width(direction) == ref.width(direction)
            assert schema.width_aligned(direction) == ref.width_aligned(direction)
            assert schema.slices(direction) == ref.slices(direction)
    assert MIXED.slices("uplink") == ((0, 128), (128, 128), (128, 384), (384, 512), (512, 768))
    with pytest.raises(ValueError, match="direction"):
        MIXED.streams("sideways")


# ------------------------------------------------------------- properties

@pytest.mark.parametrize("shape", [(256,), (3, 256), (2, 3, 128)])
def test_int8_error_bound(shape):
    x = _inputs(shape, seed=0) * 7.0
    err = np.abs(n(transport.roundtrip(t(x), INT8)) - x)
    step = _chunk_steps(x, 128) / 127.0
    assert (err <= 0.5 * step + 1e-7 * (1 + step)).all()


def test_fp8_error_bound():
    x = np.random.default_rng(1).normal(size=(4, 256)).astype(np.float32)
    err = np.abs(n(transport.roundtrip(t(x), FP8)) - x)
    # e4m3 keeps 3 mantissa bits: after the per-chunk rescale to 448 the
    # error is at most half the step at the chunk's top, 16/448 of max|chunk|
    assert (err <= _chunk_steps(x, 128) / 16.0 + 1e-7).all()


@pytest.mark.parametrize("cfg", [INT8, FP8], ids=KINDS)
def test_zero_chunks_exact(cfg):
    np.testing.assert_array_equal(n(transport.roundtrip(torch.zeros(3, 256), cfg)), 0.0)
    x = _inputs((2, 384), seed=2, tail=128)  # an aligned tail quantizes to exact 0
    np.testing.assert_array_equal(n(transport.roundtrip(t(x), cfg))[:, -128:], 0.0)


@pytest.mark.parametrize("seed", range(8))
def test_per_stream_roundtrip_and_residuals(seed):
    """A mixed schema whose first stream is 10^4 times louder than the
    rest: each delta slice within its own int8 bound, raw and relay slices
    passed through bit for bit with a zero EF slice, and each delta
    stream's EF its own residual, to within 4 f32 ulp of the stream's
    largest operand (the residual computed as ``carry − deq`` against
    ``delta − applied``)."""
    rng = np.random.default_rng(seed)
    w = MIXED.width_aligned("uplink")
    pre = rng.normal(size=(2, w)).astype(np.float32)
    post = pre.copy()
    post[:, :128] += (rng.normal(size=(2, 128)) * 100.0).astype(np.float32)
    post[:, 128:] += (rng.normal(size=(2, w - 128)) * 0.01).astype(np.float32)
    stage = transport.make_wire_stage(MIXED, INT8, "uplink")
    out, ef = (n(a) for a in stage(t(pre), t(post), torch.zeros(2, w)))
    applied, delta = out - pre, post - pre
    for s, (lo, hi) in zip(MIXED.streams("uplink"), MIXED.slices("uplink")):
        if s.coding != "delta":
            np.testing.assert_array_equal(out[:, lo:hi], post[:, lo:hi], err_msg=s.name)
            np.testing.assert_array_equal(ef[:, lo:hi], 0.0, err_msg=s.name)
        elif hi > lo:
            d = delta[:, lo:hi]
            step = _chunk_steps(d, 128) / 127.0
            err = np.abs(applied[:, lo:hi] - d)
            assert (err <= 0.5 * step + 1e-6 * (1 + step)).all(), s.name
            magnitude = max(np.abs(pre[:, lo:hi]).max(), np.abs(post[:, lo:hi]).max())
            tol = 4 * np.finfo(np.float32).eps * magnitude
            np.testing.assert_allclose(ef[:, lo:hi], d - applied[:, lo:hi], rtol=0, atol=tol,
                                       err_msg=s.name)


@pytest.mark.parametrize("cfg", [INT8, FP8], ids=KINDS)
def test_error_feedback_telescopes_per_stream(cfg):
    """SCAFFOLD's two uplink streams, constant deltas five decades apart:
    after 17 rounds each stream's applied sum lies within one of ITS OWN
    quantization steps of 17·delta (int8: max|chunk|/127; fp8: the e4m3
    step at the chunk's top, 32/448 of max|chunk|), and equals 17·delta − ef."""
    schema = WireSchema("scaffold", uplink=(Stream("delta", 256), Stream("control_delta", 256)))
    stage = transport.make_wire_stage(schema, cfg, "uplink")
    rng = np.random.default_rng(7)
    parts = [rng.normal(size=(3, 256)).astype(np.float32) * 50.0,
             rng.normal(size=(3, 256)).astype(np.float32) * 1e-3]
    delta = torch.as_tensor(np.concatenate(parts, axis=-1))
    pre, ef = torch.zeros_like(delta), torch.zeros_like(delta)
    total = np.zeros(delta.shape, np.float32)
    rounds = 17
    for _ in range(rounds):
        out, ef = stage(pre, pre + delta, ef)
        total += n(out - pre)
    per_step = 127.0 if cfg.kind == "int8" else 448.0 / 32.0
    for d, (lo, hi) in zip(parts, schema.slices("uplink")):
        step = _chunk_steps(d, 128) / per_step
        err = np.abs(total[:, lo:hi] - rounds * d)
        assert (err <= step + 1e-5 * (1 + np.abs(d))).all()
        np.testing.assert_allclose(err, np.abs(n(ef)[:, lo:hi]), rtol=0,
                                   atol=1e-5 * (1 + np.abs(d).max()))


def test_config_validation():
    with pytest.raises(ValueError, match="kind"):
        TransportConfig("int4")
    with pytest.raises(ValueError, match="positive"):
        TransportConfig("int8", chunk=0)
    with pytest.raises(ValueError, match="does not divide"):
        transport.quantize(torch.zeros(2, 100), TransportConfig(chunk=64))
    with pytest.raises(ValueError, match="coding"):
        Stream("x", 8, coding="zip")
    with pytest.raises(ValueError, match=">= 0"):
        Stream("x", -1)
    assert transport.make_stage(None) is None
    assert transport.make_wire_stage(MIXED, None) is None
    for bad in ("int8", ref_transport.TransportConfig("int8")):
        with pytest.raises(TypeError, match="TransportConfig"):
            transport.make_stage(bad)
        with pytest.raises(TypeError, match="TransportConfig"):
            transport.make_wire_stage(MIXED, bad)


def test_chunk_mismatch_names_strategy_stream_and_widths():
    """chunk=192 divides the first stream's 384-wide slice but not the
    second's 256: the error names the offending stream."""
    schema = WireSchema("scaffold", uplink=(Stream("delta", 300), Stream("control_delta", 250)))
    with pytest.raises(ValueError) as exc:
        transport.make_wire_stage(schema, TransportConfig(chunk=192), "uplink")
    for needle in ("scaffold", "control_delta", "250", "256", "192", "does not divide"):
        assert needle in str(exc.value), (needle, str(exc.value))
    with pytest.raises(ValueError) as ref_exc:
        ref_transport.make_wire_stage(_ref_schema(schema),
                                      ref_transport.TransportConfig(chunk=192), "uplink")
    assert str(exc.value) == str(ref_exc.value)


def test_direction_without_a_delta_stream_has_no_stage():
    schema = WireSchema("cfl_like", downlink=(Stream("cluster_models", 130, coding="raw"),))
    assert transport.make_wire_stage(schema, INT8, "downlink") is None
    relay = WireSchema("fedfomo", downlink=(Stream("peer_models", 130, coding="relay"),))
    assert transport.make_wire_stage(relay, INT8, "downlink") is None
    assert transport.make_wire_stage(WireSchema("local"), INT8, "downlink") is None


def test_single_stream_stage_is_make_stage():
    schema = transport.single_delta_schema("fedavg", 300)
    stage = transport.make_wire_stage(schema, INT8, "uplink")
    pre, post, ef = (t(a) for a in _stage_inputs(3, 384, seed=0))
    for a, b in zip(stage(pre, post, ef), transport.make_stage(INT8)(pre, post, ef)):
        assert torch.equal(a, b)


def test_unsupported_names_the_strategy():
    with pytest.raises(NotImplementedError, match="ucfl_parallel.*capability matrix"):
        transport.unsupported(INT8, "ucfl_parallel", "no single slab")
    assert transport.unsupported(None, "ucfl_parallel", "off is fine") is None
