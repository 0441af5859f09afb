"""The port's wire layer (``repro_torch.wire``) and wire-audited runs
against the reference's, on the CPU.

* **bytes** -- the port's bitio, codecs, frames and sessions write the
  reference's bytes for the same inputs (hypothesis over field widths, f32
  bit patterns, index widths, plan segments, sign passes, top-k and dense
  payloads); the golden session built with the port's package equals
  ``tests/golden/wire_session_v2.bin`` byte for byte (read, never written);
  the format constants equal the reference's.
* **channels** -- for every registry scheme the port's wire hooks are
  lossless (the decoded tensors equal the direct path's) and each stream's
  payload bits equal the booked bits; plan headers round-trip at the booked
  overhead; the EF flush's wire form equals the flush.
* **runs** -- every registry scheme's 3-round ``wire="audit"`` run is
  bit-identical to its unaudited host run and reconciles; the BiCompFL mask
  variants' audited sessions equal the reference's byte for byte, and the
  delta schemes' have equal frames with payload floats within
  ``FLOAT_ATOL``; ``wire_scheme_ids`` and the refusals are the reference's.
"""
import functools
import math
from types import SimpleNamespace

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # container has no hypothesis: deterministic fallback
    from _hypothesis_fallback import given, settings, st

import jax
import numpy as np
import pytest
import torch

from repro import wire as jw
from repro.fl import registry as jreg
from repro.fl.data import make_synthetic, partition_iid
from repro.fl.engine import FLEngine as JEngine
from repro.fl.nets import make_mlp
from repro.fl.tasks import make_cfl_task, make_mask_task
from repro.wire import codecs as jcodecs
from repro_torch import convert, wire as tw
from repro_torch.core.bernoulli import bern_kl, clip01
from repro_torch.core.blocks import FixedAllocation
from repro_torch.core.mrc import sample_mean
from repro_torch.core.quantizers import sign_bits, topk_bits
from repro_torch.fl import channels as tch
from repro_torch.fl import registry as treg
from repro_torch.fl.channels import BlockPlan, RoundContext, WireEnv
from repro_torch.fl.engine import EngineSpec, FLEngine, MeanDeltaAggregator
from repro_torch.wire import (DIR_CTRL, DIR_DOWN, DIR_FLUSH_DOWN, DIR_FLUSH_UP, DIR_UP,
                              SERVER, BitReader, BitWriter, Message, WireCapacityError,
                              WireFormatError, WireSession, codecs, scheme_wire_id)

N, D = 3, 96
SCHEMES = treg.all_schemes(n=N, d=D, n_is=8, block=32, reset_period=2, include_adaptive=True)
SCHEME_IDS = [s[0] for s in SCHEMES]
# Engine runs: a small MLP (d = 16*8 + 8*10), the registry at that d.
ENGINE_D = 208
T_ENGINE = treg.all_schemes(n=N, d=ENGINE_D, n_is=8, block=32, reset_period=2,
                            include_adaptive=True)
J_ENGINE = jreg.all_schemes(n=N, d=ENGINE_D, n_is=8, block=32, reset_period=2,
                            include_adaptive=True)
ENGINE_IDS = [s[0] for s in T_ENGINE]
MASK_IDS = [s[0] for s in T_ENGINE if s[1] == "mask"]
DELTA_IDS = [s[0] for s in T_ENGINE if s[1] == "delta"]
# The delta schemes' payload floats (temperatures, scales, deltas, models)
# against the reference's: dense training sums in torch's order, a few ulp
# from XLA's, as test_torch_baselines.py's THETA_ATOL for whole runs.
FLOAT_ATOL = 1e-6

GOLDEN = __import__("pathlib").Path(__file__).resolve().parent / "golden"


def _same_bytes(fill_port, fill_ref):
    """Run one fill on each package's BitWriter; both must write the same
    bits and bytes.  Returns the port's writer."""
    wt, wj = BitWriter(), jw.BitWriter()
    fill_port(wt)
    fill_ref(wj)
    assert wt.bits_written == wj.bits_written
    assert wt.getvalue() == wj.getvalue()
    return wt


# ---------------------------------------------------------------------------
# bitio, codecs, frames: the reference's bytes.
# ---------------------------------------------------------------------------


class TestBytes:
    @settings(max_examples=25, deadline=None)
    @given(st.lists(st.tuples(st.integers(min_value=1, max_value=48),
                              st.integers(min_value=0, max_value=2 ** 48 - 1)),
                    min_size=1, max_size=12))
    def test_fields_write_the_reference_bytes(self, fields):
        fields = [(wd, v & ((1 << wd) - 1)) for wd, v in fields]

        def fill(w):
            for wd, v in fields:
                w.write(v, wd)

        w = _same_bytes(fill, fill)
        r = BitReader(w.getvalue(), w.bits_written)
        assert [r.read(wd) for wd, _ in fields] == [v for _, v in fields]
        r.expect_exhausted()

    @settings(max_examples=25, deadline=None)
    @given(st.lists(st.integers(min_value=0, max_value=2 ** 32 - 1), min_size=1, max_size=9),
           st.integers(min_value=0, max_value=7))
    def test_f32_bit_patterns_write_the_reference_bytes(self, patterns, lead):
        xs = np.asarray(patterns, np.uint32).view(np.float32)

        def fill(w):
            if lead:
                w.write(1, lead)  # the unaligned, bit-by-bit path
            w.write_f32_array(xs)
            w.write_f32(xs[0])

        w = _same_bytes(fill, fill)
        r = BitReader(w.getvalue(), w.bits_written)
        if lead:
            r.read(lead)
        np.testing.assert_array_equal(r.read_f32_array(len(xs)).view(np.uint32),
                                      xs.view(np.uint32))
        assert r.read_f32().view(np.uint32) == xs[0].view(np.uint32)

    @settings(max_examples=20, deadline=None)
    @given(st.integers(min_value=1, max_value=10), st.integers(min_value=1, max_value=4),
           st.integers(min_value=1, max_value=9), st.integers(min_value=0, max_value=2 ** 31))
    def test_indices_write_the_reference_bytes(self, log_n_is, rows, cols, seed):
        n_is = 2 ** log_n_is
        idx = np.random.default_rng(seed).integers(0, n_is, size=(rows, cols))
        w = _same_bytes(lambda w: codecs.put_indices(w, idx, n_is),
                        lambda w: jcodecs.put_indices(w, idx, n_is))
        assert w.bits_written == idx.size * log_n_is        # the booked rate
        r = BitReader(w.getvalue(), w.bits_written)
        np.testing.assert_array_equal(codecs.get_indices(r, idx.shape, n_is), idx)

    @settings(max_examples=20, deadline=None)
    @given(st.lists(st.integers(min_value=1, max_value=64), min_size=1, max_size=12),
           st.integers(min_value=0, max_value=9))
    def test_plan_headers_write_the_reference_bytes(self, lengths, log_size):
        seg = np.repeat(np.arange(len(lengths)), lengths)
        w = _same_bytes(lambda w: codecs.put_plan_segments(w, seg, 64),
                        lambda w: jcodecs.put_plan_segments(w, seg, 64))
        assert w.bits_written == len(lengths) * 6
        np.testing.assert_array_equal(
            codecs.get_plan_segments(BitReader(w.getvalue(), w.bits_written), seg.size, 64),
            seg)
        size = 2 ** log_size
        w = _same_bytes(lambda w: codecs.put_plan_avg(w, size, 512),
                        lambda w: jcodecs.put_plan_avg(w, size, 512))
        assert codecs.get_plan_avg(BitReader(w.getvalue(), w.bits_written), 512) == size

    @settings(max_examples=20, deadline=None)
    @given(st.integers(min_value=1, max_value=70), st.integers(min_value=0, max_value=2 ** 31),
           st.integers(min_value=1, max_value=3))
    def test_sign_topk_dense_write_the_reference_bytes(self, d, seed, passes):
        rng = np.random.default_rng(seed)
        vals = rng.standard_normal(d).astype(np.float32)
        scales = np.abs(rng.standard_normal(passes)).astype(np.float32)
        signs = rng.random((passes, d)) < 0.5

        def sign_fill(cod):
            return lambda w: [cod.put_sign_pass(w, s, b) for s, b in zip(scales, signs)]

        w = _same_bytes(sign_fill(codecs), sign_fill(jcodecs))
        assert w.bits_written == passes * sign_bits(d)
        r = BitReader(w.getvalue(), w.bits_written)
        for s, b in zip(scales, signs):
            s2, b2 = codecs.get_sign_pass(r, d)
            assert s2.view(np.uint32) == s.view(np.uint32)
            np.testing.assert_array_equal(b2, b)
        k = int(rng.integers(1, d + 1))
        idx = rng.choice(d, size=k, replace=False)
        w = _same_bytes(lambda w: codecs.put_topk(w, idx, vals[idx], d),
                        lambda w: jcodecs.put_topk(w, idx, vals[idx], d))
        assert w.bits_written == topk_bits(d, k)
        i2, v2 = codecs.get_topk(BitReader(w.getvalue(), w.bits_written), k, d)
        np.testing.assert_array_equal(i2, idx)
        np.testing.assert_array_equal(v2.view(np.uint32), vals[idx].view(np.uint32))
        w = _same_bytes(lambda w: codecs.put_dense(w, vals),
                        lambda w: jcodecs.put_dense(w, vals))
        np.testing.assert_array_equal(
            codecs.get_dense(BitReader(w.getvalue(), w.bits_written), d).view(np.uint32),
            vals.view(np.uint32))

    def test_misuse_is_loud(self):
        with pytest.raises(WireCapacityError):
            codecs.index_width(6)       # log2(6) books fractional bits
        w = BitWriter()
        with pytest.raises(WireFormatError):
            w.write(4, 2)
        with pytest.raises(WireFormatError):
            BitReader(b"\x00", 9)
        with pytest.raises(WireFormatError, match="non-decreasing"):
            codecs.put_plan_segments(BitWriter(), np.repeat(np.arange(3), [2, 5, 1])[::-1], 8)

    def test_format_constants_are_the_references(self):
        for name in ("FRAME_HEADER_BITS", "FRAME_TRAILER_BITS", "FRAME_OVERHEAD_BITS",
                     "VERSION", "MAGIC", "RECONCILE_TOL_BITS", "RECONCILE_REL_TOL",
                     "SERVER", "DIR_UP", "DIR_DOWN", "DIR_CTRL", "DIR_FLUSH_UP",
                     "DIR_FLUSH_DOWN", "UPLINK_DIRS", "DOWNLINK_DIRS"):
            assert getattr(tw, name) == getattr(jw, name), name
        assert (tw.FRAME_HEADER_BITS, tw.FRAME_TRAILER_BITS, tw.VERSION) == (144, 32, 2)
        assert (tw.RECONCILE_TOL_BITS, tw.RECONCILE_REL_TOL) == (0.0, 1e-9)
        assert scheme_wire_id("golden-v1") == jw.scheme_wire_id("golden-v1")

    def test_messages_and_sessions_write_the_reference_bytes(self):
        kw = dict(direction=DIR_UP, sender=2, recipient=SERVER, payload=b"\xAB\xC0",
                  payload_bits=11, round=9, scheme_id=0x1234)
        m, jm = Message(**kw), jw.Message(**kw)
        assert m.to_bytes() == jm.to_bytes()
        assert Message.from_bytes(jm.to_bytes()) == m
        s, js = WireSession(scheme_id=77), jw.WireSession(scheme_id=77)
        for sess, cls in ((s, Message), (js, jw.Message)):
            sess.add([cls(direction=DIR_CTRL, sender=1, recipient=SERVER, payload=b"\x80",
                          payload_bits=1)], round=0)
            sess.add([cls(direction=DIR_DOWN, sender=SERVER, recipient=0,
                          payload=b"\x01\x02\x03", payload_bits=24)], round=1)
        assert s.to_bytes() == js.to_bytes()
        assert WireSession.parse(js.to_bytes()).to_bytes() == js.to_bytes()


def _golden_session() -> WireSession:
    """``tests/test_wire.py``'s golden session, built with the port's package."""
    s = WireSession(scheme_id=scheme_wire_id("golden-v1"))

    def msg(direction, sender, recipient, fill):
        w = BitWriter()
        fill(w)
        return Message(direction=direction, sender=sender, recipient=recipient,
                       payload=w.getvalue(), payload_bits=w.bits_written)

    ctrl = msg(DIR_CTRL, 0, SERVER, lambda w: codecs.put_plan_segments(
        w, np.repeat(np.arange(3), [2, 5, 1]), 8))
    up_idx = msg(DIR_UP, 1, SERVER, lambda w: codecs.put_indices(
        w, np.arange(12).reshape(3, 4) % 8, 8))
    up_sign = msg(DIR_UP, 2, SERVER, lambda w: codecs.put_sign_pass(
        w, np.float32(0.5), [True, False] * 8 + [True]))
    up_topk = msg(DIR_FLUSH_UP, 0, SERVER, lambda w: codecs.put_topk(
        w, [3, 11, 4], np.float32([1.5, -2.25, 0.125]), 16))
    down = msg(DIR_DOWN, SERVER, 1, lambda w: codecs.put_dense(
        w, np.float32([0.0, -0.0, 3.5, -1e-8])))
    flush_dn = msg(DIR_FLUSH_DOWN, SERVER, 2, lambda w: codecs.put_dense(
        w, np.float32([2.0, -4.0])))
    s.add([ctrl, up_idx, up_sign], round=0)
    s.add([up_topk, down, flush_dn], round=1)
    return s


def test_golden_session_is_the_committed_file():
    data = (GOLDEN / "wire_session_v2.bin").read_bytes()
    assert _golden_session().to_bytes() == data
    p = WireSession.parse(data)
    assert [m.direction for m in p.messages] == \
        [DIR_CTRL, DIR_UP, DIR_UP, DIR_FLUSH_UP, DIR_DOWN, DIR_FLUSH_DOWN]


# ---------------------------------------------------------------------------
# Channel hooks: lossless, and the stream carries exactly the booked bits.
# ---------------------------------------------------------------------------


def _round_inputs(kind: str, key: int = 0):
    rng = np.random.default_rng(key)
    if kind == "mask":
        draw = lambda shape: rng.uniform(0.05, 0.95, shape)  # noqa: E731
    else:
        draw = rng.standard_normal
    t = lambda a: torch.tensor(np.asarray(a, np.float32))  # noqa: E731
    return t(draw((N, D))), t(draw((N, D))), t(draw(D))


def _ctx(spec, payload, priors):
    plan = None
    if spec.allocation is not None:
        kl = None
        if getattr(spec.allocation, "needs_kl", True):
            kl = sample_mean(bern_kl(payload, clip01(priors))).numpy()
        size, n_blocks, seg_ids, overhead = spec.allocation.plan(kl, D)
        plan = BlockPlan(size=size, n_blocks=n_blocks, seg_ids=seg_ids, overhead_bits=overhead)
    return RoundContext(t=0, key=convert.key(jax.random.PRNGKey(7), "cpu"), n_clients=N,
                        d=D, active=np.arange(N), plan=plan)


def _bits_close(stream_bits, booked):
    return math.isclose(stream_bits, booked, rel_tol=tw.RECONCILE_REL_TOL,
                        abs_tol=tw.RECONCILE_TOL_BITS)


@pytest.mark.parametrize("name,kind,factory", SCHEMES, ids=SCHEME_IDS)
def test_channel_hooks_lossless_and_stream_matches_booked(name, kind, factory):
    spec = factory()
    payload, priors, theta = _round_inputs(kind)
    ctx = _ctx(spec, payload, priors)
    theta_hat = theta[None].repeat(N, 1)

    up_direct, ul_direct = spec.uplink.transmit(ctx, payload, priors)
    update = spec.aggregator(ctx, theta, up_direct)
    th_d, thh_d, dl_direct = spec.downlink.distribute(ctx, update, theta, theta_hat)
    for chan in (spec.uplink, spec.downlink):
        getattr(chan, "reset", lambda: None)()

    _, ul_wire, up_msgs = spec.uplink.transmit_wire(ctx, payload, priors)
    up_dec = spec.uplink.decode_up(ctx, up_msgs, priors)
    assert torch.equal(up_dec, up_direct) and ul_wire == ul_direct, name
    update_w = spec.aggregator(ctx, theta, up_dec)
    _, dn_msgs = spec.downlink.distribute_wire(ctx, update_w, theta, theta_hat, up_msgs)
    env = WireEnv(uplink=spec.uplink, aggregator=spec.aggregator, priors=priors,
                  up_msgs=up_msgs, update=update_w)
    th_w, thh_w, dl_wire = spec.downlink.decode_down(ctx, dn_msgs, theta, theta_hat, env)
    assert torch.equal(th_w, th_d) and torch.equal(thh_w, thh_d), name
    assert dl_wire == dl_direct, name
    assert all(m.direction == DIR_UP for m in up_msgs), name
    assert all(m.direction == DIR_DOWN for m in dn_msgs), name
    assert _bits_close(sum(m.payload_bits for m in up_msgs), ul_direct), name
    assert _bits_close(sum(m.payload_bits for m in dn_msgs), dl_direct), name


@pytest.mark.parametrize("name,kind,factory",
                         [s for s in SCHEMES if s[2]().allocation is not None],
                         ids=[s[0] for s in SCHEMES if s[2]().allocation is not None])
def test_plan_header_roundtrip_at_booked_overhead(name, kind, factory):
    spec = factory()
    payload, priors, _ = _round_inputs(kind)
    plan = _ctx(spec, payload, priors).plan
    w = BitWriter()
    spec.allocation.encode_plan(plan, w)
    assert w.bits_written == plan.overhead_bits, name
    r = BitReader(w.getvalue(), w.bits_written)
    plan2 = spec.allocation.decode_plan(r, D)
    r.expect_exhausted()
    assert (plan2.size, plan2.n_blocks) == (plan.size, plan.n_blocks), name
    assert float(plan2.overhead_bits) == float(plan.overhead_bits), name
    if plan.seg_ids is None:
        assert plan2.seg_ids is None
    else:
        np.testing.assert_array_equal(np.asarray(plan2.seg_ids), np.asarray(plan.seg_ids))


@pytest.mark.parametrize("scheme", ["cser", "liec"])
def test_flush_wire_matches_flush(scheme):
    mk = lambda: treg.baseline_spec(scheme, n=N, d=D, reset_period=2)  # noqa: E731
    payload, priors, _ = _round_inputs("delta")
    s1, s2 = mk(), mk()
    s1.uplink.transmit(_ctx(s1, payload, priors), payload, priors)  # fill the EF memories
    s2.uplink.transmit(_ctx(s2, payload, priors), payload, priors)
    r1, b1 = s1.uplink.flush(N, D)
    _, b2, msgs = s2.uplink.flush_wire(N, D)
    assert b2 == b1 and len(msgs) == N
    assert all(m.direction == DIR_FLUSH_UP for m in msgs)
    assert _bits_close(sum(m.payload_bits for m in msgs), b1)
    assert torch.equal(s2.uplink.decode_flush_up(msgs, N, D), r1)


# ---------------------------------------------------------------------------
# Engine runs: audited == unaudited, and the reference's sessions.
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def wire_setup():
    k = jax.random.PRNGKey(6)
    train, test = make_synthetic(k, n_train=120, n_test=30, hw=4, noise=0.5)
    shards = partition_iid(jax.random.fold_in(k, 1), train, N, 40)
    net = make_mlp(in_dim=16, widths=(8,), signed_constant=True)
    mask = make_mask_task(net, jax.random.fold_in(k, 2), test.x, test.y, local_epochs=1,
                          batch_size=20)
    # Several Adam steps: after one, every |delta| is the step size and the
    # top-k of M3 picks among ties that only rounding tells apart.
    cfl, theta0 = make_cfl_task(make_mlp(in_dim=16, widths=(8,)), jax.random.fold_in(k, 3),
                                test.x, test.y, local_epochs=2, batch_size=10, local_lr=3e-3)
    assert int(theta0.shape[0]) == ENGINE_D
    tmask = convert.mask_task(mask.w0_flat, mask.x_test, mask.y_test, dims=(16, 8, 10),
                              device="cpu", local_epochs=1, batch_size=20, lr=mask.lr)
    tcfl, ttheta0 = convert.cfl_task(theta0, cfl.x_test, cfl.y_test, dims=(16, 8, 10),
                                     device="cpu", local_epochs=2, batch_size=10,
                                     local_lr=3e-3)
    ref = {"mask": (mask, None), "delta": (cfl, theta0)}
    port = {"mask": (tmask, None), "delta": (tcfl, ttheta0)}
    return ref, shards, port, convert.dataset(shards.x, shards.y, "cpu")


@functools.lru_cache(maxsize=None)
def _runs(name, setup_id):
    """(port direct, port audited, reference audited) 3-round host runs of one
    registry scheme, computed once per module."""
    ref, shards, port, tshards = _SETUP[setup_id]
    i = ENGINE_IDS.index(name)
    kind = T_ENGINE[i][1]
    task, theta0 = port[kind]
    kw = dict(rounds=3, seed=1, mode="host")
    direct = FLEngine(task, T_ENGINE[i][2]()).run(tshards, theta0, **kw)
    audited = FLEngine(task, T_ENGINE[i][2]()).run(tshards, theta0, wire="audit", **kw)
    jtask, jtheta0 = ref[kind]
    want = JEngine(jtask, J_ENGINE[i][2]()).run(shards, jtheta0, wire="audit", **kw)
    return direct, audited, want


_SETUP = {}


def _cached(name, wire_setup):
    _SETUP[id(wire_setup)] = wire_setup
    return _runs(name, id(wire_setup))


@pytest.mark.parametrize("name", ENGINE_IDS)
def test_wire_audited_run_bit_identical_and_reconciles(name, wire_setup):
    direct, audited, _ = _cached(name, wire_setup)
    assert torch.equal(audited["theta"], direct["theta"]), name
    assert torch.equal(audited["theta_hat"], direct["theta_hat"]), name
    assert audited["history"] == direct["history"], name
    assert audited["meter"] == direct["meter"], name
    rep = audited["wire"]     # reconcile raises on any divergence
    assert rep["messages"] > 0
    assert rep["uplink_err_bits"] == 0.0 and rep["downlink_err_bits"] == 0.0
    session = audited["wire_session"]
    spec_name = T_ENGINE[ENGINE_IDS.index(name)][2]().name
    assert all(m.scheme_id == scheme_wire_id(spec_name) for m in session.messages)
    parsed = WireSession.parse(session.to_bytes())
    assert [(m.round, m.direction, m.sender, m.recipient, m.payload_bits, m.payload)
            for m in parsed.messages] == \
        [(m.round, m.direction, m.sender, m.recipient, m.payload_bits, m.payload)
         for m in session.messages]


@pytest.mark.parametrize("name", MASK_IDS)
def test_mask_variant_sessions_are_the_references_bytes(name, wire_setup):
    _, audited, want = _cached(name, wire_setup)
    assert audited["wire_session"].to_bytes() == want["wire_session"].to_bytes(), name
    assert audited["meter"] == want["meter"]
    assert audited["wire"] == want["wire"]
    np.testing.assert_array_equal(audited["theta"].numpy(), np.asarray(want["theta"]))
    np.testing.assert_array_equal(audited["theta_hat"].numpy(), np.asarray(want["theta_hat"]))


def _fields(spec, m, d):
    """A delta scheme's frame as (integer fields, float32 fields)."""
    r = BitReader(m.payload, m.payload_bits)
    chan = spec.uplink if m.direction == DIR_UP or (
        m.direction == DIR_DOWN and isinstance(spec.downlink, tch.IndexRelayDownlink)) \
        else spec.downlink
    ints, floats = [], []
    if m.direction == DIR_CTRL:
        ints = list(m.payload)
    elif m.direction in (DIR_FLUSH_UP, DIR_FLUSH_DOWN) or \
            isinstance(chan, (tch.DenseChannel, tch.SliceDownlink)):
        floats = list(r.read_f32_array(m.payload_bits // 32))
    elif isinstance(chan, tch.QuantizedMRCUplink):
        floats = [r.read_f32()]
        ints = [r.read(3) for _ in range(r.bits_left // 3)]          # n_is = 8
    elif isinstance(chan, tch.SignEFChannel):
        for _ in range(chan.passes):
            scale, sgn = codecs.get_sign_pass(r, d)
            floats.append(scale)
            ints += sgn.tolist()
    elif isinstance(chan, tch.TopKEFChannel):
        idx, vals = codecs.get_topk(r, m.payload_bits // (32 + codecs.topk_index_width(d)), d)
        ints, floats = idx.tolist(), vals.tolist()
    else:
        raise AssertionError(type(chan).__name__)
    r.expect_exhausted()
    return ints, np.asarray(floats, np.float32)


@pytest.mark.parametrize("name", DELTA_IDS)
def test_delta_scheme_sessions_match_the_references(name, wire_setup):
    """Equal frames (round, direction, sender, recipient, payload bits and
    every integer field); payload floats within FLOAT_ATOL."""
    _, audited, want = _cached(name, wire_setup)
    spec = T_ENGINE[ENGINE_IDS.index(name)][2]()
    got_msgs, want_msgs = audited["wire_session"].messages, want["wire_session"].messages
    assert len(got_msgs) == len(want_msgs)
    for g, w in zip(got_msgs, want_msgs):
        assert (g.round, g.direction, g.sender, g.recipient, g.payload_bits, g.scheme_id) == \
            (w.round, w.direction, w.sender, w.recipient, w.payload_bits, w.scheme_id)
        gi, gf = _fields(spec, g, ENGINE_D)
        wi, wf = _fields(spec, w, ENGINE_D)
        assert gi == wi, (name, g.round, g.direction, g.sender, g.recipient)
        np.testing.assert_allclose(gf, wf, atol=FLOAT_ATOL, rtol=0)
    assert audited["meter"] == want["meter"]


def test_wire_scheme_ids_are_the_references():
    ids = treg.wire_scheme_ids(n=N, d=D)
    assert ids == jreg.wire_scheme_ids(n=N, d=D)
    assert set(ids) == {f().name for _, _, f in SCHEMES}
    assert len(set(ids.values())) == len(ids)


def test_wire_audit_refusals(wire_setup):
    _, _, port, tshards = wire_setup
    task = port["mask"][0]
    eng = FLEngine(task, T_ENGINE[0][2]())
    with pytest.raises(ValueError, match="host path"):
        eng.run(tshards, rounds=1, mode="fused", wire="audit")
    with pytest.raises(ValueError, match="wire="):
        eng.run(tshards, rounds=1, mode="host", wire="bogus")
    with pytest.raises(ValueError, match="cannot checkpoint or resume"):
        eng.run(tshards, rounds=1, mode="host", wire="audit", checkpoint_dir="unused")
    spec = EngineSpec(uplink=SimpleNamespace(), downlink=SimpleNamespace(),
                      aggregator=MeanDeltaAggregator(), name="no-wire")
    with pytest.raises(ValueError, match="cannot be wire-audited"):
        FLEngine(task, spec).run(tshards, rounds=1, mode="host", wire="audit")
    spec = treg.bicompfl_spec("GR", allocation=FixedAllocation(32), n_is=6, n_dl=N)
    with pytest.raises(ValueError, match=r"MRCFixedChannel has n_is=6"):
        FLEngine(task, spec).run(tshards, rounds=3, seed=1, mode="host", wire="audit")
    # off the wire, a non-pow2 n_is is legal (bits booked at the log2 rate)
    assert len(FLEngine(task, spec).run(tshards, rounds=1, seed=1, mode="host")["history"]) == 1
