"""The §V-D communication model in both packages.

``repro_torch.core.comm_model`` is the reference's numpy-only module kept
as the port's own copy. Every public function, on the same arguments,
returns the same number in both (exact: the same float arithmetic in the
same order): schemes, cohort sizes, transports, deadlines, async K, tiers,
and ``wire_bytes`` of each strategy's declared schema (the port's
``WireSchema`` against the reference's). The reference's own property
tests (``tests/test_comm_model.py``) are then run once more with the
port's module in place of the reference's.
"""
import itertools
import types

import numpy as np
import pytest

import test_comm_model as ref_properties
from repro.core import comm_model as ref_cm
from repro.federated import transport as ref_transport
from repro_torch.core import comm_model as cm
from repro_torch.federated import transport

D = 47571  # LeNet-5 at scenario 2's widths
SCHEMES = [("broadcast", None), ("groupcast", 4), ("unicast", None), ("client_mixing", None)]
COHORTS = [None, 1, 7, 50, 200]
KINDS = [None, "int8", "fp8"]
CHUNKS = [128, 64, 100]


def _schemas(pkg, dim=D):
    """Each strategy's schema as its constructor declares it, in ``pkg``."""
    s, one = pkg.Stream, pkg.single_delta_schema
    return {
        "ucfl": one("ucfl", dim, downlink=(s("personalized", dim),)),
        "ucfl_k4": one("ucfl_k4", dim, downlink=(s("centroids", dim, coding="raw"),)),
        "fedavg": one("fedavg", dim, downlink=(s("model", dim),)),
        "fedprox": one("fedprox", dim, downlink=(s("model", dim),)),
        "local": one("local", dim),
        "oracle": one("oracle", dim, downlink=(s("group_models", dim, coding="raw"),)),
        "scaffold": pkg.WireSchema("scaffold", uplink=(s("delta", dim), s("control_delta", dim)),
                                   downlink=(s("model", dim), s("control", dim))),
        "ditto": one("ditto", dim, downlink=(s("model", dim),)),
        "pfedme": one("pfedme", dim, downlink=(s("average", dim, coding="raw"),)),
        "fedfomo": one("fedfomo", dim, downlink=(s("peer_models", dim, coding="relay"),)),
        "cfl": one("cfl", dim, downlink=(s("cluster_models", dim, coding="raw"),)),
    }


def _transports(kind, chunk):
    if kind is None:
        return None, None
    return transport.TransportConfig(kind, chunk), ref_transport.TransportConfig(kind, chunk)


def _params(pkg, **kw):
    tiers = kw.pop("tiers", None)
    return pkg.SystemParams(tiers=None if tiers is None else pkg.TierParams(**tiers), **kw)


SYSTEMS = [dict(m=100), dict(m=20, rho=2.0, t_dl=0.5, t_min=0.3, inv_mu=0.0),
           dict(m=100, rho=4.0, inv_mu=2.0, tiers=dict(num_edges=4, backhaul_dl=0.25,
                                                        congestion=0.1)),
           dict(m=20, rho=4.0, inv_mu=1.0, tiers=dict(num_edges=4, backhaul_dl=0.0,
                                                       congestion=0.0))]


def _same(got, want):
    if isinstance(want, tuple):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w)
    elif isinstance(want, np.ndarray):
        np.testing.assert_array_equal(got, want)
    else:
        assert got == want and type(got) is type(want), (got, want)


def _both(fn, *args, **kw):
    """Run ``fn`` of both modules on the same arguments: (port, reference),
    or the same exception type from both."""
    out = []
    for mod in (cm, ref_cm):
        try:
            out.append(getattr(mod, fn)(*args, **kw))
        except ValueError as e:
            out.append(type(e))
    _same(*out)
    return out[0]


def test_harmonic_and_transport_scale():
    for m in (1, 2, 7, 100, 1000):
        _both("harmonic", m)
    for kind, chunk in itertools.product(KINDS, CHUNKS):
        t, rt = _transports(kind, chunk)
        _same(cm.transport_ul_scale(t), ref_cm.transport_ul_scale(rt))


@pytest.mark.parametrize("sys_i", range(len(SYSTEMS)))
def test_round_times_match(sys_i):
    p, rp = _params(cm, **SYSTEMS[sys_i]), _params(ref_cm, **SYSTEMS[sys_i])
    schemas, ref_schemas = _schemas(transport), _schemas(ref_transport)
    for (scheme, k), c in itertools.product(SCHEMES, COHORTS):
        for kind, name in itertools.product(KINDS, [None, "ucfl", "fedavg", "scaffold"]):
            t, rt = _transports(kind, 128)
            s, rs = (None, None) if name is None else (schemas[name], ref_schemas[name])
            outs = []
            for mod, pp, tt, ss in ((cm, p, t, s), (ref_cm, rp, rt, rs)):
                try:
                    outs.append((
                        mod.round_time(pp, scheme, k, c, transport=tt, schema=ss),
                        mod.rounds_to_time(pp, scheme, 3, k, c, transport=tt, schema=ss),
                        mod.expected_compute_time(pp, c),
                    ))
                except ValueError as e:  # tiered per-client schemes raise in both
                    outs.append(type(e))
            _same(*outs)


@pytest.mark.parametrize("sys_i", range(len(SYSTEMS)))
def test_deadline_and_async_prices_match(sys_i):
    p, rp = _params(cm, **SYSTEMS[sys_i]), _params(ref_cm, **SYSTEMS[sys_i])
    t, rt = _transports("int8", 128)
    s, rs = _schemas(transport)["fedavg"], _schemas(ref_transport)["fedavg"]
    for (scheme, k), c in itertools.product(SCHEMES, [None, 8, 50]):
        outs = []
        for mod, pp, tt, ss in ((cm, p, t, s), (ref_cm, rp, rt, rs)):
            row = []
            for deadline in (np.inf, 1.5, 2.5, 0.1):
                try:
                    row.append(mod.deadline_round_time(pp, scheme, k, c, deadline=deadline,
                                                       transport=tt, schema=ss))
                except ValueError as e:
                    row.append(type(e))
            compute = np.linspace(1.0, 4.0, 8)
            try:
                row.append(mod.deadline_round_time(pp, scheme, k, c, deadline=2.0,
                                                   compute=compute))
            except ValueError as e:
                row.append(type(e))
            for flush_k, applied in ((1, None), (4, None), (4, 0), (8, 8), (99, 3)):
                try:
                    row.append(mod.async_round_time(pp, scheme, k, c, flush_k=flush_k,
                                                    applied=applied, transport=tt, schema=ss))
                except ValueError as e:
                    row.append(type(e))
            for kth in (1, 3, 50, 500):
                row.append(mod.expected_kth_compute_time(pp, kth, c))
            row.append(mod.sample_arrival_times(pp, np.random.default_rng(7), c))
            outs.append(tuple(row))
        _same(*outs)


@pytest.mark.parametrize("name", sorted(_schemas(transport)))
def test_wire_bytes_of_each_schema_match(name):
    s, rs = _schemas(transport)[name], _schemas(ref_transport)[name]
    for kind, chunk in itertools.product(KINDS, CHUNKS):
        t, rt = _transports(kind, chunk)
        for direction in ("uplink", "downlink"):
            _same(cm.wire_bytes(s, t, direction), ref_cm.wire_bytes(rs, rt, direction))
        for (scheme, k), c, edges in itertools.product(SCHEMES, COHORTS, (None, 3)):
            mb = 4 * D
            outs = []
            for mod, tt, ss in ((cm, t, s), (ref_cm, rt, rs)):
                row = [mod.uplink_bytes_per_round(mb, scheme, 100, c, transport=tt, schema=ss),
                       mod.downlink_bytes_per_round(mb, scheme, 100, k, c, transport=tt,
                                                    schema=ss),
                       mod.uplink_bytes_per_round(mb + 1, scheme, 100, c, transport=tt)]
                for fn in ("ps_uplink_bytes_per_round", "ps_downlink_bytes_per_round"):
                    try:
                        row.append(getattr(mod, fn)(mb, scheme, 100, k, c, num_edges=edges,
                                                    transport=tt, schema=ss))
                    except ValueError as e:
                        row.append(type(e))
                try:
                    row.append(mod.ici_collective_bytes(mb, scheme, 100, k, c))
                except ValueError as e:
                    row.append(type(e))
                outs.append(tuple(row))
            _same(*outs)


def test_bad_arguments_raise_alike():
    p, rp = cm.SystemParams(m=20), ref_cm.SystemParams(m=20)
    for fn, args in (("round_time", ("nope",)), ("round_time", ("groupcast",)),
                     ("async_round_time", ("groupcast",))):
        kw = {"flush_k": 2, "cohort_size": 8} if fn.startswith("async") else {}
        with pytest.raises(ValueError):
            getattr(cm, fn)(p, *args, **kw)
        with pytest.raises(ValueError):
            getattr(ref_cm, fn)(rp, *args, **kw)
    _both("downlink_bytes_per_round", 1000, "groupcast", 20)
    _both("uplink_bytes_per_round", 1000, "nope", 20)
    _both("ici_collective_bytes", 1000, "nope", 20)
    bad = types.SimpleNamespace(chunk=0)  # wire_bytes is duck-typed on .chunk
    with pytest.raises(ValueError, match="positive"):
        cm.wire_bytes(_schemas(transport)["fedavg"], bad)
    with pytest.raises(ValueError, match="positive"):
        cm.transport_ul_scale(bad)


PROPERTIES = sorted(n for n in dir(ref_properties) if n.startswith("test_"))


@pytest.mark.parametrize("name", PROPERTIES)
def test_reference_properties_hold_for_the_port(name, monkeypatch):
    """Each test of the reference's ``tests/test_comm_model.py``, run on
    the port's module."""
    monkeypatch.setattr(ref_properties, "cm", cm)
    getattr(ref_properties, name)()


def test_quantized_delta_uplink_prices_at_least_3_5x_fewer_bytes():
    """The reference's participation-sweep gate, on every schema with a
    delta uplink: int8 uploads at least 3.5× fewer bytes than raw."""
    for name, s in _schemas(transport).items():
        raw = cm.uplink_bytes_per_round(4 * D, "broadcast", 100, 50, schema=s)
        q = cm.uplink_bytes_per_round(4 * D, "broadcast", 100, 50,
                                      transport=transport.TransportConfig("int8"), schema=s)
        assert raw / q >= 3.5, name
