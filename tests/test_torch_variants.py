"""The port's BiCompFL-GR-Reconst, PR and PR-SplitDL against the reference, on the CPU.

Covers ``prng.choice`` / ``prng.permutation`` (jax 0.9's sort-based
shuffle), the engine's cohort schedule under both cohort RNGs, the segment
codec under per-client keys, the new channels' invariants (mirrored from
``tests/test_channels.py``), the registry's refusals, and whole runs of each
variant under each allocation it supports, engine against engine (the
reference in host mode), with every channel recording its MRC indices.
Integers (cohorts, plans, indices, bits) must match exactly; ``theta`` and
``theta_hat`` are held bit for bit.  The CUDA kernels themselves run only
on the card (``test_torch_cuda.py``).
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import blocks as jblocks
from repro.core import mrc as jm
from repro.core.bernoulli import clip01 as j_clip01, log_ratio_coeffs as j_coeffs
from repro.fl import channels as jch
from repro.fl.data import make_synthetic as j_make_synthetic, partition_iid as j_partition
from repro.fl.engine import FLEngine as JEngine
from repro.fl.federator import BiCompFLConfig as JConfig, run_bicompfl as j_run_bicompfl
from repro.fl.nets import make_mlp as j_make_mlp
from repro.fl.registry import bicompfl_spec as j_spec
from repro.fl.tasks import make_mask_task as j_make_task
from repro_torch import convert, prng
from repro_torch.core import blocks as tblocks
from repro_torch.core import mrc as tm
from repro_torch.fl import channels as tch
from repro_torch.fl.engine import FLEngine as TEngine
from repro_torch.fl.federator import BiCompFLConfig as TConfig, run_bicompfl as t_run_bicompfl
from repro_torch.fl.registry import bicompfl_spec as t_spec

HW, WIDTH, N_CLIENTS, SHARD = 6, 32, 5, 80
DIMS = (HW * HW, WIDTH, 10)                     # d = 36*32 + 32*10 = 1472
BLOCK, N_IS, N_DL, ROUNDS = 64, 16, 3, 3        # 23 blocks: SplitDL pads 2 of 5 lists
# Gumbel-max near-ties: a mismatched index is allowed only where the
# reference's top-2 gap in logW + gumbel is below this (as in
# test_torch_adaptive.py: the segment sums run in another order).
NEAR_TIE = 1e-4


# ---------------------------------------------------------------------------
# prng.choice and prng.permutation.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 2, 10, 100, 1000, 5000])
@pytest.mark.parametrize("seed", [0, 1, 77])
def test_choice_and_permutation_match_jax(n, seed):
    """Bit for bit jax 0.9's ``permutation`` and ``choice(replace=False)``;
    n = 5000 takes two sort rounds, the others one (n = 1 none)."""
    k = jax.random.PRNGKey(seed)
    tk = convert.key(k, "cpu")
    np.testing.assert_array_equal(prng.permutation(tk, n).numpy(),
                                  np.asarray(jax.random.permutation(k, n)))
    for m in sorted({1, max(1, n // 3), n}):
        np.testing.assert_array_equal(
            prng.choice(tk, n, (m,), replace=False).numpy(),
            np.asarray(jax.random.choice(k, n, (m,), replace=False)))


def test_choice_is_batched_over_keys_and_takes_jax_shapes():
    ks = jax.random.split(jax.random.PRNGKey(3), 6)
    want = jax.vmap(lambda k: jax.random.choice(k, 10, (2, 3), replace=False))(ks)
    got = prng.choice(convert.key(ks, "cpu"), 10, (2, 3), replace=False)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    k = jax.random.PRNGKey(4)
    np.testing.assert_array_equal(prng.choice(convert.key(k, "cpu"), 7, (5,)).numpy(),
                                  np.asarray(jax.random.choice(k, 7, (5,))))
    with pytest.raises(ValueError):
        prng.choice(convert.key(k, "cpu"), 3, (4,), replace=False)


# ---------------------------------------------------------------------------
# Cohort schedule.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cohort_rng", ["numpy", "jax"])
@pytest.mark.parametrize("rounds,n,n_active,seed", [(6, 10, 5, 0), (4, 5, 2, 3),
                                                    (3, 100, 37, 1), (5, 4, 4, 2),
                                                    (2, 7, 1, 9)])
def test_cohort_schedule_matches_reference(cohort_rng, rounds, n, n_active, seed):
    want = JEngine.cohort_schedule(rounds, n, n_active, seed, cohort_rng)
    got = TEngine.cohort_schedule(rounds, n, n_active, seed, cohort_rng)
    assert got.dtype == np.int64 and got.shape == (rounds, n_active)
    np.testing.assert_array_equal(got, want)


def test_cohort_schedule_refuses_unknown_rng():
    with pytest.raises(ValueError):
        TEngine.cohort_schedule(2, 4, 2, 0, "torch")


# ---------------------------------------------------------------------------
# The codecs under per-client (private) keys.
# ---------------------------------------------------------------------------


def _qp(rng, shape, spread=0.1):
    q = rng.uniform(0.02, 0.98, shape).astype(np.float32)
    p = np.clip(q + spread * rng.standard_normal(shape), 0, 1).astype(np.float32)
    return q, p


def _segmentation(rng, d):
    cuts = np.sort(rng.choice(np.arange(1, d), size=max(1, d // 40), replace=False))
    seg = np.zeros(d, np.int32)
    seg[cuts] = 1
    seg = np.cumsum(seg).astype(np.int32)
    return seg, int(seg[-1]) + 1


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


@pytest.mark.parametrize("seed,clients,d,n_is,n_samples",
                         [(0, 4, 600, 32, 2), (1, 3, 1472, 16, 1), (2, 1, 77, 8, 3)])
def test_segment_codec_with_client_keys_matches_vmapped_reference(seed, clients, d, n_is,
                                                                  n_samples):
    """transmit_segments / receive_segments with (C, 2) candidate keys
    equal the reference's vmap of them over the clients; an index may
    differ only at a near-tie of the reference (counted)."""
    rng = np.random.default_rng(seed)
    q, p = _qp(rng, (clients, d))
    seg, n_seg = _segmentation(rng, d)
    kt = jax.random.PRNGKey(seed)
    ks = jax.vmap(lambda i: jm.client_key(kt, i))(jnp.arange(clients))
    sks = jax.random.split(jax.random.fold_in(kt, 2), clients)
    ji, jq = jax.vmap(lambda k, s, q_, p_: jm.transmit_segments(
        k, s, q_, p_, jnp.asarray(seg), n_is=n_is, n_seg=n_seg, n_samples=n_samples))(
        ks, sks, jnp.asarray(q), jnp.asarray(p))
    tks = tm.client_key(convert.key(kt, "cpu"), torch.arange(clients))
    np.testing.assert_array_equal(tks.numpy(), np.asarray(ks).astype(np.int64))
    ti, tq = tm.transmit_segments(tks, convert.key(sks, "cpu"), torch.tensor(q),
                                  torch.tensor(p), seg, n_is=n_is, n_seg=n_seg,
                                  n_samples=n_samples)
    ji, ti = np.asarray(ji), ti.numpy()
    assert ti.shape == ji.shape == (clients, n_samples, n_seg)
    diff = ji != ti
    for c, ell in zip(*np.nonzero(diff.any(-1))):
        gap = _near_tie_gap(jm.sample_key(ks[c], ell), jm.sample_key(sks[c], ell), q[c],
                            p[c], seg, n_seg, n_is)
        assert (gap[diff[c, ell]] < NEAR_TIE).all(), gap[diff[c, ell]]
    print(f"client-key segment codec near-tie mismatches: {int(diff.sum())} of {diff.size}")
    if not diff.any():
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    back = tm.receive_segments(tks, torch.tensor(ti), torch.tensor(p), seg, n_is=n_is)
    want = jax.vmap(lambda k, i, p_: jm.receive_segments(
        k, i, p_, jnp.asarray(seg), n_is=n_is))(ks, jnp.asarray(ti), jnp.asarray(p))
    np.testing.assert_array_equal(back.numpy(), np.asarray(want))
    np.testing.assert_array_equal(back.numpy(), tq.numpy())


def test_segment_plain_version_takes_client_keys_and_the_hook():
    """The plain encoder under (C, 2) keys: each client's rows are its own
    key's draw, and a ``seg_logw_fn`` is called once per client with the
    client's (n_is, d) candidates."""
    rng = np.random.default_rng(5)
    q, p = _qp(rng, (3, 200))
    seg, n_seg = _segmentation(rng, 200)
    keys = prng.split(prng.PRNGKey(5, device="cpu"), 3)
    sels = prng.split(prng.PRNGKey(6, device="cpu"), 3)
    calls = []

    def hook(u, *rest):
        calls.append(tuple(u.shape))
        return tm.default_segment_logw(u, *rest)

    a = tm.encode_segments(keys, sels, torch.tensor(q), torch.tensor(p), seg, n_is=8,
                           n_seg=n_seg)
    b = tm.encode_segments(keys, sels, torch.tensor(q), torch.tensor(p), seg, n_is=8,
                           n_seg=n_seg, seg_logw_fn=hook)
    assert calls == [(8, 200)] * 3
    assert torch.equal(a.indices, b.indices) and torch.equal(a.sample, b.sample)
    for c in range(3):
        one = tm.encode_segments(keys[c], sels[c], torch.tensor(q[c]), torch.tensor(p[c]),
                                 seg, n_is=8, n_seg=n_seg)
        assert torch.equal(one.indices, a.indices[c]) and torch.equal(one.sample, a.sample[c])


def test_fixed_codec_with_client_keys_matches_vmapped_reference():
    rng = np.random.default_rng(7)
    q, p = _qp(rng, (4, 7, 16))
    kt = jax.random.PRNGKey(7)
    ks = jax.vmap(lambda i: jm.client_key(kt, i))(jnp.arange(4))
    sks = jax.random.split(kt, 4)
    ji, jq = jax.vmap(lambda k, s, q_, p_: jm.transmit_fixed(
        k, s, q_, p_, n_is=32, n_samples=2))(ks, sks, jnp.asarray(q), jnp.asarray(p))
    ti, tq = tm.transmit_fixed(convert.key(ks, "cpu"), convert.key(sks, "cpu"),
                               torch.tensor(q), torch.tensor(p), n_is=32, n_samples=2)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))


# ---------------------------------------------------------------------------
# Channel invariants (mirrors of tests/test_channels.py), port against reference.
# ---------------------------------------------------------------------------

N, D = 4, 96


def _ctxs(active=None, size=32):
    active = np.arange(N) if active is None else np.asarray(active)
    jplan = jch.BlockPlan(size=size, n_blocks=-(-D // size), seg_ids=None,
                          overhead_bits=0.0)
    tplan = tch.BlockPlan(size=size, n_blocks=-(-D // size), seg_ids=None,
                          overhead_bits=0.0)
    key = jax.random.PRNGKey(0)
    return (jch.RoundContext(t=0, key=key, n_clients=N, d=D, active=active, plan=jplan),
            tch.RoundContext(t=0, key=convert.key(key, "cpu"), n_clients=N, d=D,
                             active=active, plan=tplan))


def _target():
    return np.random.default_rng(0).uniform(0, 1, D).astype(np.float32)


def test_fixed_uplink_partial_cohort_bills_active_only():
    jctx, tctx = _ctxs(active=[0, 2])
    q = np.random.default_rng(1).uniform(0.2, 0.8, (2, D)).astype(np.float32)
    p = np.full((2, D), 0.5, np.float32)
    jq, jbits = jch.MRCFixedChannel(n_is=16, shared=False).transmit(jctx, jnp.asarray(q),
                                                                    jnp.asarray(p))
    tq, tbits = tch.MRCFixedChannel(n_is=16, shared=False).transmit(tctx, torch.tensor(q),
                                                                    torch.tensor(p))
    assert tq.shape == (2, D)
    assert tbits == jbits == 2 * tctx.plan.n_blocks * math.log2(16)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))


def test_private_downlink_updates_only_active():
    jctx, tctx = _ctxs(active=[1, 3])
    tgt = _target()
    jres = jch.MRCPrivateDownlink(n_is=16, n_samples=2).distribute(
        jctx, jch.ServerUpdate(theta=jnp.asarray(tgt)), jnp.zeros(D), jnp.full((N, D), 0.5))
    tres = tch.MRCPrivateDownlink(n_is=16, n_samples=2).distribute(
        tctx, tch.ServerUpdate(theta=torch.tensor(tgt)), torch.zeros(D),
        torch.full((N, D), 0.5))
    assert tres.bits == jres.bits == 2 * 2 * tctx.plan.n_blocks * math.log2(16)
    th = tres.theta_hat.numpy()
    np.testing.assert_array_equal(th[[0, 2]], np.full((2, D), 0.5, np.float32))
    assert not np.array_equal(th[1], np.full(D, 0.5, np.float32))
    np.testing.assert_array_equal(th, np.asarray(jres.theta_hat))
    assert not tch.MRCPrivateDownlink().broadcast_shareable


def test_split_downlink_bits_divided_by_n():
    jctx, tctx = _ctxs(size=8)                                   # 12 blocks over 4 clients
    tgt = _target()
    full = tch.MRCPrivateDownlink(n_is=16, n_samples=4)
    split = tch.SplitBlockDownlink(n_is=16, n_samples=4)
    th0 = torch.full((N, D), 0.5)
    rf = full.distribute(tctx, tch.ServerUpdate(theta=torch.tensor(tgt)), torch.zeros(D), th0)
    rs = split.distribute(tctx, tch.ServerUpdate(theta=torch.tensor(tgt)), torch.zeros(D), th0)
    max_len = -(-tctx.plan.n_blocks // N)
    assert rs.bits == N * 4 * max_len * math.log2(16)
    assert rs.bits < rf.bits
    js = jch.SplitBlockDownlink(n_is=16, n_samples=4).distribute(
        jctx, jch.ServerUpdate(theta=jnp.asarray(tgt)), jnp.zeros(D), jnp.full((N, D), 0.5))
    assert rs.bits == js.bits
    np.testing.assert_array_equal(rs.theta_hat.numpy(), np.asarray(js.theta_hat))


def test_split_downlink_pads_with_a_discarded_sentinel_block():
    """B = 13 over 4 clients: lists of 4, three padded with the sentinel; a
    client's estimate changes only on its own blocks, and the candidate key
    of a block is its position in the client's list."""
    d, size = 13 * 8 - 3, 8
    own, max_len = tch.SplitBlockDownlink._ownership(N, 13)
    assert max_len == 4 and own.tolist() == [[0, 4, 8, 12], [1, 5, 9, 13], [2, 6, 10, 13],
                                             [3, 7, 11, 13]]
    plan = tch.BlockPlan(size=size, n_blocks=13, seg_ids=None, overhead_bits=0.0)
    key = jax.random.PRNGKey(3)
    tctx = tch.RoundContext(t=0, key=convert.key(key, "cpu"), n_clients=N, d=d,
                            active=np.arange(N), plan=plan)
    jctx = jch.RoundContext(t=0, key=key, n_clients=N, d=d, active=np.arange(N),
                            plan=jch.BlockPlan(size=size, n_blocks=13, seg_ids=None,
                                               overhead_bits=0.0))
    tgt = np.random.default_rng(3).uniform(0, 1, d).astype(np.float32)
    th0 = np.full((N, d), 0.5, np.float32)
    idx, new, bits = tch.SplitBlockDownlink(n_is=16, n_samples=2)._transmit(
        tctx, tch.ServerUpdate(theta=torch.tensor(tgt)), torch.tensor(th0))
    jidx, jnew, jbits = jch.SplitBlockDownlink(n_is=16, n_samples=2)._transmit(
        jctx, jch.ServerUpdate(theta=jnp.asarray(tgt)), jnp.asarray(th0))
    assert idx.shape == (N, 2, max_len) and bits == jbits == N * 2 * 4 * 4
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(new.numpy(), np.asarray(jnew))
    changed = (new.numpy() != 0.5).reshape(N, -1)
    blocks = np.pad(changed, ((0, 0), (0, 3))).reshape(N, 13, size).any(-1)
    for i in range(N):
        assert set(np.nonzero(blocks[i])[0]) <= set(range(i, 13, N))


def test_broadcast_downlink_gives_every_client_one_estimate():
    jctx, tctx = _ctxs()
    tgt = _target()
    th = np.random.default_rng(2).uniform(0.3, 0.7, (N, D)).astype(np.float32)
    tres = tch.MRCBroadcastDownlink(n_is=16, n_samples=3).distribute(
        tctx, tch.ServerUpdate(theta=torch.tensor(tgt)), torch.zeros(D), torch.tensor(th))
    jres = jch.MRCBroadcastDownlink(n_is=16, n_samples=3).distribute(
        jctx, jch.ServerUpdate(theta=jnp.asarray(tgt)), jnp.zeros(D), jnp.asarray(th))
    assert tres.bits == jres.bits == N * 3 * tctx.plan.n_blocks * math.log2(16)
    assert bool((tres.theta_hat == tres.theta_hat[0]).all())
    np.testing.assert_array_equal(tres.theta_hat.numpy(), np.asarray(jres.theta_hat))
    np.testing.assert_array_equal(tres.theta.numpy(), tgt)


# ---------------------------------------------------------------------------
# Registry and federator.
# ---------------------------------------------------------------------------


def test_registry_builds_every_variant_as_the_reference_does():
    allocs = {"fixed": (jblocks.FixedAllocation(BLOCK), tblocks.FixedAllocation(BLOCK)),
              "adaptive-avg": (jblocks.AdaptiveAvgAllocation(n_is=N_IS),
                               tblocks.AdaptiveAvgAllocation(n_is=N_IS)),
              "adaptive": (jblocks.AdaptiveAllocation(n_is=N_IS),
                           tblocks.AdaptiveAllocation(n_is=N_IS))}
    for variant in ("GR", "GR-Reconst", "PR", "PR-SplitDL"):
        for name, (ja, ta) in allocs.items():
            if variant == "PR-SplitDL" and name == "adaptive":
                continue
            js = j_spec(variant, allocation=ja, n_is=N_IS, n_dl=7)
            ts = t_spec(variant, allocation=ta, n_is=N_IS, n_dl=7)
            assert ts.name == js.name
            for role in ("uplink", "downlink"):
                jc, tc = getattr(js, role), getattr(ts, role)
                assert type(tc).__name__ == type(jc).__name__
                for f in ("n_is", "n_samples", "shared", "broadcast_shareable"):
                    assert getattr(tc, f, None) == getattr(jc, f, None), (variant, role, f)
    ts = t_spec("PR", allocation=tblocks.FixedAllocation(BLOCK), participation=0.5)
    assert ts.participation == 0.5


def test_registry_refuses_what_the_reference_refuses():
    for variant in ("GR", "GR-Reconst", "PR-SplitDL"):
        with pytest.raises(ValueError):
            j_spec(variant, allocation=jblocks.FixedAllocation(BLOCK), participation=0.5)
        with pytest.raises(ValueError):
            t_spec(variant, allocation=tblocks.FixedAllocation(BLOCK), participation=0.5)
    with pytest.raises(NotImplementedError):
        j_spec("PR-SplitDL", allocation=jblocks.AdaptiveAllocation(n_is=N_IS))
    with pytest.raises(NotImplementedError):
        t_spec("PR-SplitDL", allocation=tblocks.AdaptiveAllocation(n_is=N_IS))
    with pytest.raises(ValueError):
        t_spec("PR-Reconst", allocation=tblocks.FixedAllocation(BLOCK))
    with pytest.raises(NotImplementedError):
        t_spec("PR", allocation=object())


# ---------------------------------------------------------------------------
# Whole runs, engine against engine.
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ref():
    """The slice test's task at lr 0.5 with 5 clients: enough KL per round
    that the adaptive plans move."""
    key = jax.random.PRNGKey(0)
    train, test = j_make_synthetic(key, n_train=400, n_test=100, hw=HW, noise=0.4)
    shards = j_partition(jax.random.fold_in(key, 1), train, N_CLIENTS, SHARD)
    net = j_make_mlp(HW * HW, (WIDTH,), signed_constant=True)
    task = j_make_task(net, jax.random.fold_in(key, 2), test.x, test.y,
                       local_epochs=2, lr=0.5, batch_size=64)
    ttask = convert.mask_task(task.w0_flat, task.x_test, task.y_test, dims=DIMS,
                              device="cpu", local_epochs=task.local_epochs, lr=task.lr,
                              batch_size=task.batch_size)
    return {"shards": shards, "task": task, "ttask": ttask,
            "tshards": convert.dataset(shards.x, shards.y, "cpu")}


def _recording(cls, host):
    """``cls`` (a channel or an allocation) logging what each round makes:
    a channel its MRC indices, an allocation its plan."""
    if hasattr(cls, "plan"):
        class Plans(cls):
            def plan(self, kl, d):
                out = super().plan(kl, d)
                self.log.append(out)
                return out
        return Plans

    class Indices(cls):
        def _transmit(self, *args):
            out = super()._transmit(*args)
            if host is None:
                self.log.append(out[0].numpy())
            else:
                host(lambda i: self.log.append(np.asarray(i)), out[0])
            return out
    return Indices


def _instrument(spec, host):
    for role in ("uplink", "downlink", "allocation"):
        obj = getattr(spec, role)
        rec = _recording(type(obj), host)
        if dataclasses.is_dataclass(obj):
            new = rec(**{f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)})
        else:
            new = rec(**{k: v for k, v in vars(obj).items()})
        new.log = []
        setattr(spec, role, new)
    return spec


def _alloc(module, name):
    if name == "fixed":
        return module.FixedAllocation(BLOCK)
    cls = module.AdaptiveAllocation if name == "adaptive" else module.AdaptiveAvgAllocation
    return cls(n_is=N_IS)


def _assert_runs_equal(jspec, tspec, jout, tout, rounds=ROUNDS):
    np.testing.assert_array_equal(tout["active_schedule"], jout["active_schedule"])
    jp, tp = jspec.allocation.log, tspec.allocation.log
    assert len(tp) == len(jp) == rounds
    for got, want in zip(tp, jp):
        assert (got[0], got[1], got[3]) == (want[0], want[1], want[3])
        assert (got[2] is None) == (want[2] is None)
        if got[2] is not None:
            np.testing.assert_array_equal(got[2], want[2])
    assert [h["cum_bits"] for h in tout["history"]] == \
        [h["cum_bits"] for h in jout["history"]]
    assert tout["meter"] == jout["meter"]
    for role in ("uplink", "downlink"):
        jl, tl = getattr(jspec, role).log, getattr(tspec, role).log
        assert len(tl) == len(jl) == rounds
        for r, (ti, ji) in enumerate(zip(tl, jl)):
            assert ti.shape == ji.shape, (role, r)
            np.testing.assert_array_equal(ti, ji, err_msg=f"{role} round {r}")
    # Every index equal, so every candidate and sample is equal: the models
    # are the same float32 arithmetic on the same bits, held bit for bit.
    np.testing.assert_array_equal(tout["theta"].numpy(), np.asarray(jout["theta"]))
    np.testing.assert_array_equal(tout["theta_hat"].numpy(), np.asarray(jout["theta_hat"]))
    for jh, th in zip(jout["history"], tout["history"]):
        assert jh["acc"] == th["acc"], (jh, th)


def _run_both(ref, variant, alloc, participation=1.0, cohort_rng="numpy", rounds=ROUNDS):
    jspec = _instrument(j_spec(variant, allocation=_alloc(jblocks, alloc), n_is=N_IS,
                               n_dl=N_DL, participation=participation), jax.debug.callback)
    tspec = _instrument(t_spec(variant, allocation=_alloc(tblocks, alloc), n_is=N_IS,
                               n_dl=N_DL, participation=participation), None)
    jout = JEngine(ref["task"], jspec).run(ref["shards"], rounds=rounds, seed=0,
                                           eval_every=1, mode="host", cohort_rng=cohort_rng)
    tout = TEngine(ref["ttask"], tspec).run(ref["tshards"], rounds=rounds, seed=0,
                                            eval_every=1, mode="host", cohort_rng=cohort_rng)
    print(f"{variant} {alloc} participation {participation} ({cohort_rng}): plans "
          f"{[(p[0], p[1]) for p in tspec.allocation.log]}, cohorts "
          f"{tout['active_schedule'].tolist()}, bits {tout['meter']['total_bits']}")
    return jspec, tspec, jout, tout


@pytest.mark.parametrize("variant,alloc", [
    ("GR-Reconst", "fixed"), ("GR-Reconst", "adaptive-avg"), ("GR-Reconst", "adaptive"),
    ("PR", "fixed"), ("PR", "adaptive-avg"), ("PR", "adaptive"), ("PR-SplitDL", "fixed")])
def test_variant_run_matches_reference(ref, variant, alloc):
    """3 rounds, 5 clients, n_is 16, n_dl 3: plans, booked bits, the meter,
    every uplink and downlink index, theta and theta_hat equal every round."""
    _assert_runs_equal(*_run_both(ref, variant, alloc))


@pytest.mark.parametrize("cohort_rng", ["numpy", "jax"])
@pytest.mark.parametrize("participation,alloc", [(0.5, "fixed"), (0.67, "adaptive")])
def test_pr_partial_participation_matches_reference(ref, participation, alloc, cohort_rng):
    """PR on a cohort of round(0.5 * 5) = 2 (half to even) or
    round(0.67 * 5) = 3 clients a round: the same cohorts, plans, bits,
    indices and estimates (stale rows for the clients left out)."""
    jspec, tspec, jout, tout = _run_both(ref, "PR", alloc, participation, cohort_rng)
    n_active = max(1, int(round(participation * N_CLIENTS)))
    assert tout["active_schedule"].shape == (ROUNDS, n_active)
    _assert_runs_equal(jspec, tspec, jout, tout)
    for r, ids in enumerate(tout["active_schedule"]):
        assert tspec.uplink.log[r].shape[0] == tspec.downlink.log[r].shape[0] == n_active


def test_run_bicompfl_matches_reference(ref):
    """The federator's entry point with the paper's n_dl = n * n_ul."""
    jout = j_run_bicompfl(ref["task"], ref["shards"], JConfig(
        variant="PR", allocation=jblocks.FixedAllocation(BLOCK), n_is=N_IS, rounds=2))
    tout = t_run_bicompfl(ref["ttask"], ref["tshards"], TConfig(
        variant="PR", allocation=tblocks.FixedAllocation(BLOCK), n_is=N_IS, rounds=2))
    assert tout["meter"] == jout["meter"]
    per_link = N_CLIENTS * (-(-1472 // BLOCK)) * math.log2(N_IS)   # one sample, all clients
    assert tout["meter"]["total_bits"] == 2 * (per_link + N_CLIENTS * per_link)
    np.testing.assert_array_equal(tout["theta_hat"].numpy(), np.asarray(jout["theta_hat"]))
