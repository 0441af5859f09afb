"""The port's adaptive block allocation against the reference, on the CPU.

Covers the two kernels' plain versions (``bernoulli_kl``, ``segment_logw``),
the host plans of ``AdaptiveAllocation`` and ``AdaptiveAvgAllocation``, the
segment codec and BiCompFL-GR runs under both allocations.  The reference's
Pallas kernels run in interpret mode where a kernel is called directly; its
engine runs in host mode.  Integers (plans, indices, bits) must match
exactly; floats within a tolerance stated where it is used.  The CUDA
kernels themselves run only on the card (``test_torch_cuda.py``).
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import blocks as jblocks
from repro.core import mrc as jm
from repro.core.bernoulli import bern_kl as j_bern_kl, clip01 as j_clip01
from repro.core.bernoulli import log_ratio_coeffs as j_coeffs
from repro.fl import channels as jch
from repro.fl.data import make_synthetic as j_make_synthetic, partition_iid as j_partition
from repro.fl.engine import FLEngine as JEngine, _kl_stats as j_kl_stats
from repro.fl.nets import make_mlp as j_make_mlp
from repro.fl.registry import bicompfl_spec as j_spec
from repro.fl.tasks import make_mask_task as j_make_task
from repro.kernels import ops as jops
from repro.kernels.ref import bernoulli_kl_ref as j_kl_ref
from repro_torch import convert, prng
from repro_torch.core import blocks as tblocks
from repro_torch.core import mrc as tm
from repro_torch.fl import channels as tch
from repro_torch.fl.engine import FLEngine as TEngine, _kl_stats as t_kl_stats
from repro_torch.fl.registry import bicompfl_spec as t_spec
from repro_torch.kernels import bernoulli_kl as tkl
from repro_torch.kernels import ops as tops
from repro_torch.kernels.segment_logw import segment_logw_ref

HW, WIDTH, N_CLIENTS, SHARD = 6, 32, 4, 80
DIMS = (HW * HW, WIDTH, 10)                     # d = 36*32 + 32*10 = 1472
N_IS, ROUNDS = 16, 3
# KL sums: the same float32 terms (logs from two libraries, ~1 ulp apart)
# summed in another order.
KL_RTOL = 1e-5
# The engine's profile: torch's and XLA's elementwise KL differ in the last
# ulp at many entries, so the cohort mean differs by a few 1e-7 relative
# (at most 4.5e-7 on the inputs below).
PROFILE_RTOL, PROFILE_ATOL = 2e-6, 1e-9
# Segment weights, port plain vs the Pallas kernel in interpret mode: f32
# sums grouped in another order (the reference's own test uses these).
SEG_RTOL, SEG_ATOL = 1e-5, 1e-4
# Gumbel-max near-ties: a mismatched index is allowed only where the
# reference's top-2 gap in logW + gumbel is below this.
NEAR_TIE = 1e-4
ACC_BAND = 0.02                                 # as in test_torch_slice.py


def _qp(rng, shape, lo=0.02, hi=0.98, spread=0.1):
    q = rng.uniform(lo, hi, shape).astype(np.float32)
    p = np.clip(q + spread * rng.standard_normal(shape), 0, 1).astype(np.float32)
    return q, p


def _random_segmentation(rng, d):
    """A random non-decreasing segmentation of [0, d): (seg_ids, n_seg)."""
    n_cuts = int(rng.integers(0, d))
    cuts = np.sort(rng.choice(np.arange(1, d), size=min(n_cuts, d - 1), replace=False)) \
        if d > 1 and n_cuts else np.array([], dtype=np.int64)
    lengths = np.diff(np.concatenate([[0], cuts, [d]]))
    return np.repeat(np.arange(lengths.size), lengths).astype(np.int32), lengths.size


# ---------------------------------------------------------------------------
# bernoulli_kl: plain versions against the reference kernel (interpret mode).
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(3, 512), (4, 700), (5, 37), (1, 1)])
def test_bernoulli_kl_plain_matches_reference(shape):
    q, p = _qp(np.random.default_rng(sum(shape)), shape)
    q[0, 0], p[0, -1] = 0.0, 1.0                # the 1e-6 clip
    tq, tp = torch.tensor(q), torch.tensor(p)
    jq, jp = jnp.asarray(q), jnp.asarray(p)
    cases = [(tops.bernoulli_kl(tq, tp), jops.bernoulli_kl(jq, jp, interpret=True)),
             (tops.bernoulli_kl(tq, tp), j_kl_ref(jq, jp)),
             (tops.bernoulli_kl_total(tq, tp),
              jops.bernoulli_kl_total(jq, jp, interpret=True)),
             (tops.bernoulli_kl_profile(tq, tp),
              jops.bernoulli_kl_profile(jq, jp, interpret=True))]
    for got, want in cases:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=KL_RTOL, atol=1e-7)


def test_bernoulli_kl_ops_cpu_take_plain_versions_and_count_nothing():
    q, p = (torch.tensor(v) for v in _qp(np.random.default_rng(1), (6, 300)))
    fns = (tops.bernoulli_kl, tops.bernoulli_kl_total, tops.bernoulli_kl_profile)
    before = [f.launches for f in fns]
    for f, ref in zip(fns, (tkl.rows_ref, tkl.total_ref, tkl.profile_ref)):
        np.testing.assert_array_equal(f(q, p).numpy(), ref(q, p).numpy())
    assert [f.launches for f in fns] == before
    # meta tensors take the plain route (shapes only, no launch); any other
    # device but cpu and cuda is refused
    out = tops.bernoulli_kl_profile(q.to("meta"), p.to("meta"))
    assert out.device.type == "meta" and out.shape == (300,)
    assert [f.launches for f in fns] == before
    with pytest.raises(ValueError, match="cpu, meta or cuda"):
        tops._route(tops.bernoulli_kl_profile, None, None,
                    types.SimpleNamespace(device=torch.device("xpu")))


@pytest.mark.parametrize("seed,n,d", [(0, 4, 1472), (1, 10, 500), (2, 3, 33)])
def test_kl_stats_match_reference_host_profile(seed, n, d):
    """``engine._kl_stats`` on the CPU against the reference host loop's
    profile and its own ``_kl_stats`` (the jnp route on the CPU): the CPU
    route returns the profile and its sum whatever ``needs_profile`` says."""
    payload, priors = _qp(np.random.default_rng(seed), (n, d), spread=0.2)
    ref_profile = np.asarray(jnp.mean(jax.vmap(j_bern_kl)(
        jnp.asarray(payload), j_clip01(jnp.asarray(priors))), axis=0))
    jstats = j_kl_stats(jnp.asarray(payload), jnp.asarray(priors), needs_profile=True)
    for needs_profile in (True, False):
        stats = t_kl_stats(torch.tensor(payload), torch.tensor(priors),
                           needs_profile=needs_profile)
        got = stats["profile"]
        rel = np.abs(got.numpy() - ref_profile) / np.abs(ref_profile)
        print(f"_kl_stats profile max rel diff: {rel.max():.2e}")
        np.testing.assert_allclose(got.numpy(), ref_profile,
                                   rtol=PROFILE_RTOL, atol=PROFILE_ATOL)
        assert float(stats["total"]) == float(got.sum())
        np.testing.assert_allclose(float(stats["total"]), float(jstats["total"]),
                                   rtol=PROFILE_RTOL)


# ---------------------------------------------------------------------------
# Host plans.
# ---------------------------------------------------------------------------


def _profiles(d):
    rng = np.random.default_rng(d)
    flat = rng.uniform(0, 0.02, d).astype(np.float32)
    peaked = (rng.pareto(1.5, d) * 1e-3).astype(np.float32)
    tiny = np.full(d, 1e-9, np.float32)
    huge = rng.uniform(5, 10, d).astype(np.float32)
    return {"cold": None, "flat": flat, "peaked": peaked, "tiny": tiny, "huge": huge}


def _assert_same_plan(got, want):
    size, n_blocks, seg, overhead = got
    assert (size, n_blocks, overhead) == (want[0], want[1], want[3])
    if want[2] is None:
        assert seg is None
    else:
        np.testing.assert_array_equal(seg, np.asarray(want[2]))
        assert seg.dtype == np.asarray(want[2]).dtype


@pytest.mark.parametrize("d", [28160, 1472, 9])
@pytest.mark.parametrize("kind", ["cold", "flat", "peaked", "tiny", "huge"])
def test_adaptive_plans_match_reference(d, kind):
    kl = _profiles(d)[kind]
    for n_is in (16, 64):
        _assert_same_plan(tblocks.AdaptiveAllocation(n_is=n_is).plan(kl, d),
                          jblocks.AdaptiveAllocation(n_is=n_is).plan(kl, d))
        _assert_same_plan(tblocks.AdaptiveAvgAllocation(n_is=n_is).plan(kl, d),
                          jblocks.AdaptiveAvgAllocation(n_is=n_is).plan(kl, d))


def test_block_plan_billable_and_kl_per_param():
    seg = np.array([0, 0, 1, 2], np.int32)
    plan = tblocks.BlockPlan(size=None, n_blocks=3, seg_ids=seg, overhead_bits=36.0)
    assert plan.adaptive and plan.billable == 3
    assert tblocks.BlockPlan(128, 5, None, 0.0, billable_blocks=4).billable == 4
    assert not tblocks.BlockPlan(128, 5, None, 0.0).adaptive
    q, p = _qp(np.random.default_rng(4), (50,))
    np.testing.assert_allclose(tblocks.kl_per_param(torch.tensor(q), torch.tensor(p)),
                               jblocks.kl_per_param(q, p), rtol=1e-5, atol=1e-7)


# ---------------------------------------------------------------------------
# segment_logw: plain versions against the reference.
# ---------------------------------------------------------------------------


def _seg_inputs(seed, n_is, d, clients=None):
    rng = np.random.default_rng(seed)
    shape = (d,) if clients is None else (clients, d)
    q, p = _qp(rng, shape)
    a, b = (np.asarray(t) for t in j_coeffs(jnp.asarray(q), jnp.asarray(p)))
    pc = np.asarray(j_clip01(jnp.asarray(p)))
    u = rng.uniform(size=(n_is, d)).astype(np.float32)
    return u, pc, a, b


def _segmentation(case, d, seed):
    if case == "single":
        return np.zeros(d, np.int32), 1
    if case == "singletons":
        return np.arange(d, dtype=np.int32), d
    return _random_segmentation(np.random.default_rng(seed), d)


@pytest.mark.parametrize("case,seed,n_is,d", [
    ("random", 0, 16, 200), ("random", 1, 5, 37), ("random", 2, 64, 1000),
    ("single", 3, 12, 70), ("singletons", 4, 12, 40)])
def test_segment_logw_plain_matches_reference(case, seed, n_is, d):
    """Bit-equal to the reference's jnp route; the Pallas kernel (interpret
    mode) within ``SEG_RTOL``/``SEG_ATOL``."""
    u, p, a, b = _seg_inputs(seed, n_is, d)
    seg, n_seg = _segmentation(case, d, seed)
    want = np.asarray(jm.default_segment_logw(*map(jnp.asarray, (u, p, a, b, seg)), n_seg))
    for fn in (segment_logw_ref, tm.default_segment_logw, tops.segment_logw):
        got = fn(*map(torch.tensor, (u, p, a, b, seg)), n_seg).numpy()
        np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    pallas = np.asarray(jops.segment_logw(*map(jnp.asarray, (u, p, a, b, seg)),
                                          n_seg=n_seg, interpret=True))
    np.testing.assert_allclose(got, pallas, rtol=SEG_RTOL, atol=SEG_ATOL)


def test_segment_logw_shared_candidates_serve_every_client():
    """u (NIS, D) with p, a, b (C, D): each client's slice is the
    reference's single-client result, bit for bit."""
    u, p, a, b = _seg_inputs(5, 16, 300, clients=3)
    seg, n_seg = _random_segmentation(np.random.default_rng(5), 300)
    before = tops.segment_logw.launches
    got = tops.segment_logw(*map(torch.tensor, (u, p, a, b, seg)), n_seg).numpy()
    assert got.shape == (3, 16, n_seg) and tops.segment_logw.launches == before
    assert tops.segment_logw_fn() is tops.segment_logw
    for c in range(3):
        want = np.asarray(jm.default_segment_logw(
            *map(jnp.asarray, (u, p[c], a[c], b[c], seg)), n_seg))
        np.testing.assert_array_equal(got[c], want)


# ---------------------------------------------------------------------------
# The segment codec.
# ---------------------------------------------------------------------------


def _seg_codec_inputs(seed, d, n_clients=None):
    rng = np.random.default_rng(seed)
    q, p = _qp(rng, (d,) if n_clients is None else (n_clients, d))
    seg, n_seg = _random_segmentation(rng, d)
    return q, p, seg, n_seg


def _near_tie_gap(k, sk, q, p, seg, n_seg, n_is):
    """Reference's top-2 gap of logW + gumbel per segment (one client)."""
    u = jm._segment_candidates(k, n_is, q.shape[0])
    a, b = j_coeffs(jnp.asarray(q), jnp.asarray(p))
    logw = jm.default_segment_logw(u, j_clip01(jnp.asarray(p)), a, b, jnp.asarray(seg),
                                   n_seg)
    gu = jax.random.uniform(sk, (n_is, n_seg))
    score = np.asarray(logw - jnp.log(-jnp.log(jnp.clip(gu, 1e-12, 1.0 - 1e-12))))
    top2 = np.sort(score, axis=0)[-2:]
    return top2[1] - top2[0]


@pytest.mark.parametrize("seed,d,n_is", [(0, 300, 16), (1, 1472, 64), (2, 41, 256),
                                         (3, 128, 2)])
def test_encode_segments_matches_reference(seed, d, n_is):
    q, p, seg, n_seg = _seg_codec_inputs(seed, d)
    k = jax.random.PRNGKey(seed)
    sk = jax.random.fold_in(k, 3)
    r = jm.encode_segments(k, sk, jnp.asarray(q), jnp.asarray(p), jnp.asarray(seg),
                           n_is=n_is, n_seg=n_seg)
    tk, tsk = convert.key(k, "cpu"), convert.key(sk, "cpu")
    t = tm.encode_segments(tk, tsk, torch.tensor(q), torch.tensor(p), seg,
                           n_is=n_is, n_seg=n_seg)
    ji, ti = np.asarray(r.indices), t.indices.numpy()
    diff = ji != ti
    if diff.any():
        gap = _near_tie_gap(k, sk, q, p, seg, n_seg, n_is)
        assert (gap[diff] < NEAR_TIE).all(), (gap[diff], ji[diff], ti[diff])
    print(f"encode_segments near-tie mismatches: {int(diff.sum())} of {diff.size}")
    same = ~diff[seg]
    np.testing.assert_array_equal(t.sample.numpy()[same], np.asarray(r.sample)[same])
    dec = tm.decode_segments(tk, t.indices, torch.tensor(p), seg, n_is=n_is)
    np.testing.assert_array_equal(dec.numpy(), t.sample.numpy())


def test_encode_segments_cohort_batch_matches_vmapped_reference():
    """One batched encode of 4 clients on shared candidates == the
    reference's per-client vmap; the kernel hook sees one call."""
    q, p, seg, n_seg = _seg_codec_inputs(5, 500, n_clients=4)
    k = jax.random.PRNGKey(5)
    sks = jax.random.split(jax.random.fold_in(k, 3), 4)
    r = jax.vmap(lambda s_, q_, p_: jm.encode_segments(
        k, s_, q_, p_, jnp.asarray(seg), n_is=32, n_seg=n_seg))(
        sks, jnp.asarray(q), jnp.asarray(p))
    calls = []

    def hook(*args):
        calls.append(args[0].shape)
        return tops.segment_logw(*args)

    t = tm.encode_segments(convert.key(k, "cpu"), convert.key(sks, "cpu"),
                           torch.tensor(q), torch.tensor(p), seg, n_is=32,
                           n_seg=n_seg, seg_logw_fn=hook)
    assert calls == [(32, 500)]
    ji, ti = np.asarray(r.indices), t.indices.numpy()
    print(f"cohort segment encode near-tie mismatches: {int((ji != ti).sum())} of {ji.size}")
    assert (ji == ti).mean() >= 0.99
    if (ji == ti).all():
        np.testing.assert_array_equal(t.sample.numpy(), np.asarray(r.sample))


def test_decode_segments_matches_reference_on_reference_indices():
    q, p, seg, n_seg = _seg_codec_inputs(8, 400)
    rng = np.random.default_rng(8)
    k = jax.random.PRNGKey(8)
    idx = rng.integers(0, 64, n_seg).astype(np.int32)
    want = jm.decode_segments(k, jnp.asarray(idx), jnp.asarray(p), jnp.asarray(seg), n_is=64)
    got = tm.decode_segments(convert.key(k, "cpu"), torch.tensor(idx), torch.tensor(p),
                             seg, n_is=64)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_transmit_and_receive_segments_match_reference():
    q, p, seg, n_seg = _seg_codec_inputs(9, 256)
    k, sk = jax.random.PRNGKey(9), jax.random.PRNGKey(10)
    ji, jq = jm.transmit_segments(k, sk, jnp.asarray(q), jnp.asarray(p), jnp.asarray(seg),
                                  n_is=32, n_seg=n_seg, n_samples=3)
    tk, tsk = convert.key(k, "cpu"), convert.key(sk, "cpu")
    ti, tq = tm.transmit_segments(tk, tsk, torch.tensor(q), torch.tensor(p), seg,
                                  n_is=32, n_seg=n_seg, n_samples=3)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    back = tm.receive_segments(tk, ti, torch.tensor(p), seg, n_is=32)
    np.testing.assert_array_equal(back.numpy(), np.asarray(
        jm.receive_segments(k, ji, jnp.asarray(p), jnp.asarray(seg), n_is=32)))


@pytest.mark.parametrize("bad", [np.array([1, 1, 2]), np.array([0, 2, 1]),
                                 np.zeros((2, 2), np.int32), np.array([], np.int32)])
def test_validate_seg_ids_refuses_what_the_reference_refuses(bad):
    with pytest.raises(ValueError) as jerr:
        jm._validate_seg_ids(bad)
    with pytest.raises(ValueError) as terr:
        tm._validate_seg_ids(bad)
    assert str(terr.value) == str(jerr.value)
    with pytest.raises(ValueError):
        tm.encode_segments(torch.tensor([0, 0]), torch.tensor([0, 1]),
                           torch.full((3,), 0.5), torch.full((3,), 0.5),
                           np.array([0, 2, 1]), n_is=4, n_seg=3)


def test_encode_segments_takes_one_shared_key():
    """GR's candidates come from one key (2,); the PR variants' per-client
    keys (C, 2) are taken too, and equal the reference's vmap over clients
    with a key each (near-ties counted as above)."""
    q, p, seg, n_seg = _seg_codec_inputs(9, 60, n_clients=2)
    k = jax.random.PRNGKey(0)
    keys = jax.random.split(k, 2)
    sels = jax.random.split(jax.random.fold_in(k, 1), 2)
    r = jax.vmap(lambda k_, s_, q_, p_: jm.encode_segments(
        k_, s_, q_, p_, jnp.asarray(seg), n_is=4, n_seg=n_seg))(
        keys, sels, jnp.asarray(q), jnp.asarray(p))
    t = tm.encode_segments(convert.key(keys, "cpu"), convert.key(sels, "cpu"),
                           torch.tensor(q), torch.tensor(p), seg, n_is=4, n_seg=n_seg)
    ji, ti = np.asarray(r.indices), t.indices.numpy()
    for c in range(2):
        diff = ji[c] != ti[c]
        if diff.any():
            gap = _near_tie_gap(keys[c], sels[c], q[c], p[c], seg, n_seg, 4)
            assert (gap[diff] < NEAR_TIE).all(), gap[diff]
        same = ~diff[seg]
        np.testing.assert_array_equal(t.sample.numpy()[c][same], np.asarray(r.sample)[c][same])
    shared = tm.encode_segments(convert.key(k, "cpu"), convert.key(sels, "cpu"),
                                torch.tensor(q), torch.tensor(p), seg, n_is=4, n_seg=n_seg)
    assert shared.indices.shape == t.indices.shape == (2, n_seg)
    with pytest.raises(RuntimeError):          # a key per element, not per some other axis
        tm.encode_segments(convert.key(jax.random.split(k, 3), "cpu"),
                           convert.key(sels, "cpu"), torch.tensor(q), torch.tensor(p), seg,
                           n_is=4, n_seg=n_seg)


# ---------------------------------------------------------------------------
# BiCompFL-GR under both adaptive allocations, engine against engine.
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ref():
    """The slice test's task with lr 0.5: enough KL per round that the plans
    move (Adaptive: 38, 29, 19 segments; Adaptive-Avg: blocks of 32, 64, 64)."""
    key = jax.random.PRNGKey(0)
    train, test = j_make_synthetic(key, n_train=400, n_test=100, hw=HW, noise=0.4)
    shards = j_partition(jax.random.fold_in(key, 1), train, N_CLIENTS, SHARD)
    net = j_make_mlp(HW * HW, (WIDTH,), signed_constant=True)
    task = j_make_task(net, jax.random.fold_in(key, 2), test.x, test.y,
                       local_epochs=2, lr=0.5, batch_size=64)
    return {"shards": shards, "task": task}


def _recording(alloc_cls):
    """A subclass of ``alloc_cls`` that logs every plan it returns."""
    class Recording(alloc_cls):
        def plan(self, kl, d):
            out = super().plan(kl, d)
            self.log.append(out)
            return out
    return Recording


class _JAdaptiveRec(jch.MRCAdaptiveChannel):
    def step_up(self, ctx, state, payload, priors):
        idxs, q_hat, bits = self._transmit(ctx, payload, priors)
        jax.debug.callback(lambda i: self.log.append(np.asarray(i)), idxs)
        return q_hat, bits, state


class _JFixedRec(jch.MRCFixedChannel):
    def step_up(self, ctx, state, payload, priors):
        idxs, q_hat, bits = self._transmit(ctx, payload, priors)
        jax.debug.callback(lambda i: self.log.append(np.asarray(i)), idxs)
        return q_hat, bits, state


class _TAdaptiveRec(tch.MRCAdaptiveChannel):
    def step_up(self, ctx, state, payload, priors):
        idxs, q_hat, bits = self._transmit(ctx, payload, priors)
        self.log.append(idxs.numpy())
        return q_hat, bits, state


class _TFixedRec(tch.MRCFixedChannel):
    def step_up(self, ctx, state, payload, priors):
        idxs, q_hat, bits = self._transmit(ctx, payload, priors)
        self.log.append(idxs.numpy())
        return q_hat, bits, state


@pytest.mark.parametrize("name", ["Adaptive", "AdaptiveAvg"])
def test_engine_adaptive_run_matches_reference(ref, name):
    """3 rounds of BiCompFL-GR, 4 clients, n_is 16: every round's plan
    equal, booked bits equal every round (overhead included), >= 99% of the
    MRC indices equal, accuracy within ``ACC_BAND``; with every index equal,
    the model is bit-identical too."""
    jcls = getattr(jblocks, f"{name}Allocation")
    tcls = getattr(tblocks, f"{name}Allocation")
    jalloc, talloc = _recording(jcls)(n_is=N_IS), _recording(tcls)(n_is=N_IS)
    jalloc.log, talloc.log = [], []
    jspec = j_spec("GR", allocation=jalloc, n_is=N_IS)
    tspec = t_spec("GR", allocation=talloc, n_is=N_IS)
    jrec, trec = ((_JAdaptiveRec, _TAdaptiveRec) if name == "Adaptive"
                  else (_JFixedRec, _TFixedRec))
    assert type(jspec.uplink) is jrec.__bases__[0]
    assert type(tspec.uplink) is trec.__bases__[0]
    jspec.uplink, tspec.uplink = jrec(n_is=N_IS), trec(n_is=N_IS)
    jspec.uplink.log, tspec.uplink.log = [], []
    t = ref["task"]
    ttask = convert.mask_task(t.w0_flat, t.x_test, t.y_test, dims=DIMS, device="cpu",
                              local_epochs=t.local_epochs, lr=t.lr,
                              batch_size=t.batch_size)
    jout = JEngine(t, jspec).run(ref["shards"], rounds=ROUNDS, seed=0, eval_every=1,
                                 mode="host")
    tout = TEngine(ttask, tspec).run(convert.dataset(ref["shards"].x, ref["shards"].y,
                                                     "cpu"),
                                     rounds=ROUNDS, seed=0, eval_every=1, mode="host")
    assert len(talloc.log) == len(jalloc.log) == ROUNDS
    for r, (got, want) in enumerate(zip(talloc.log, jalloc.log)):
        print(f"round {r}: plan size {got[0]}, n_blocks {got[1]}, overhead {got[3]}")
        _assert_same_plan(got, want)
    assert [h["cum_bits"] for h in tout["history"]] == \
        [h["cum_bits"] for h in jout["history"]]
    assert tout["meter"] == jout["meter"]
    ji = np.concatenate([i.ravel() for i in jspec.uplink.log])
    ti = np.concatenate([i.ravel() for i in tspec.uplink.log])
    rate = float((ji == ti).mean())
    print(f"engine MRC index match rate: {rate:.4f} over {ji.size} indices")
    assert rate >= 0.99
    if rate == 1.0:
        np.testing.assert_array_equal(tout["theta"].numpy(), np.asarray(jout["theta"]))
    for jh, th in zip(jout["history"], tout["history"]):
        assert abs(jh["acc"] - th["acc"]) <= ACC_BAND, (jh, th)
