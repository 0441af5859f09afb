"""The port's BiCompFL-GR-CFL against the reference, on the CPU.

Covers ``core/quantizers`` (the stochastic quantizers and the baselines'
compressors, with zeros and tied magnitudes among the inputs), the dense
``CFLTask`` (local training from the reference's ``theta0``, carried across
by ``convert.cfl_task``: the port's own Kaiming draw agrees with
``jax.random.normal`` only to a few ulp), ``QuantizedMRCUplink`` and
``MeanDeltaAggregator`` fed the reference's payload, the relay's side
information, whole runs engine against engine (the reference in host
mode), ``federator.run_bicompfl_cfl`` and the CPU entry point.  Integers
(indices, bits) must match exactly (indices outside Gumbel near-ties);
floats within the tolerance stated where it is used.  The ``mrc_logw``
kernel itself runs only on the card (``test_torch_cuda.py``, ``chip_smoke.py``).
"""
import dataclasses
import inspect
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import mrc as jm
from repro.core import quantizers as jq
from repro.core.bernoulli import clip01 as j_clip01, log_ratio_coeffs as j_coeffs
from repro.fl import channels as jch
from repro.fl.data import make_synthetic as j_make_synthetic, partition_iid as j_partition
from repro.fl.engine import FLEngine as JEngine, MeanDeltaAggregator as JMeanDelta
from repro.fl.federator import CFLConfig as JCFLConfig, run_bicompfl_cfl as j_run_cfl
from repro.fl.nets import make_mlp as j_make_mlp
from repro.fl.registry import cfl_spec as j_cfl_spec
from repro.fl.tasks import make_cfl_task as j_make_cfl_task
from repro_torch import cfl_gradient_compression, convert, prng
from repro_torch.core import quantizers as tq
from repro_torch.core.blocks import BlockPlan
from repro_torch.fl import channels as tch
from repro_torch.fl import registry as treg
from repro_torch.fl.engine import FLEngine as TEngine, MeanDeltaAggregator as TMeanDelta
from repro_torch.fl.federator import CFLConfig as TCFLConfig, run_bicompfl_cfl as t_run_cfl
from repro_torch.fl.nets import make_mlp as t_make_mlp
from repro_torch.fl.tasks import make_cfl_task as t_make_cfl_task

HW, WIDTH, N_CLIENTS, SHARD = 6, 32, 5, 80
DIMS = (HW * HW, WIDTH, 10)                     # d = 36*32 + 32*10 = 1472
N_IS, BLOCK, ROUNDS = 16, 16, 3
# Means over a vector (K = mean|delta|, the sign scale, the QSGD norm): the
# same float32 terms summed in torch's order and in XLA's; a sum of n terms
# rounds with ~log2(n) ulp of spread.  Measured: at most 2 ulp here.
SUM_MAX_ULP = 8
# sigmoid, log and friends of torch and XLA differ by an ulp or two; values
# derived from them (q, the QSGD levels) are held at this relative bound.
FN_RTOL = 1e-6
# Dense training through another matmul order: local-training deltas
# (theta - w_fin, rounded at the ulp of |theta| <= 0.6) and whole-run
# models agree to a few ulp of the weights.  Measured max |diff|: deltas
# 6.0e-8, theta 1.5e-8 after 3 CFL rounds; the bound is ~30 ulp of 0.5.
DELTA_ATOL = 1e-6
THETA_ATOL = 1e-6
# Gumbel-max near-ties: an index may differ only where the reference's
# top-2 gap of logW + gumbel is below this (as in the variant tests).
NEAR_TIE = 1e-4
# Accuracy on 100 test points of two models within THETA_ATOL: one point
# may fall on the other side of an argmax.
ACC_BAND = 0.02


def _ulp_diff(a, b):
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(a - b)


def _grad_like(seed, shape, scale=0.01):
    """Gradient-like inputs with exact zeros and tied magnitudes among them."""
    rng = np.random.default_rng(seed)
    g = (scale * rng.standard_normal(shape)).astype(np.float32)
    flat = g.reshape(-1, g.shape[-1])
    flat[:, 3] = 0.0
    flat[:, 7] = scale
    flat[:, 11] = -scale
    flat[:, 19] = scale
    return g


# ---------------------------------------------------------------------------
# core/quantizers.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed,temperature", [(0, 1.0), (1, 0.003), (2, "mean")])
def test_stochastic_sign_matches_reference(seed, temperature):
    g = _grad_like(seed, (4, 300))
    temp = np.abs(g).mean(-1, keepdims=True).astype(np.float32) if temperature == "mean" \
        else temperature
    want = np.stack([np.asarray(jq.stochastic_sign(jnp.asarray(r), temperature=t).q)
                     for r, t in zip(g, np.broadcast_to(temp, (4, 1))[:, 0])])
    got = tq.stochastic_sign(torch.tensor(g), temperature=torch.tensor(temp)
                             if temperature == "mean" else temp)
    np.testing.assert_allclose(got.q.numpy(), want, rtol=FN_RTOL, atol=0)
    assert got.q.numpy()[:, 3].tolist() == [0.5] * 4       # a zero is a fair coin
    bits = np.array([0.0, 0.25, 1.0], np.float32)
    np.testing.assert_array_equal(got.value(torch.tensor(bits)).numpy(),
                                  np.asarray(jq.SignPosterior(q=None).value(jnp.asarray(bits))))


@pytest.mark.parametrize("seed,s", [(0, 1), (1, 4), (2, 16)])
def test_qsgd_and_its_sample_match_reference(seed, s):
    g = _grad_like(seed, (500,))
    jp = jq.qsgd(jnp.asarray(g), s=s)
    tp = tq.qsgd(torch.tensor(g), s=s)
    assert _ulp_diff(tp.norm.numpy()[0], np.asarray(jp.norm)) <= SUM_MAX_ULP
    np.testing.assert_array_equal(tp.sign.numpy(), np.asarray(jp.sign))   # ternary: 0 at 0
    np.testing.assert_array_equal(tp.tau.numpy(), np.asarray(jp.tau))
    np.testing.assert_allclose(tp.q.numpy(), np.asarray(jp.q), rtol=0, atol=s * 4e-7)
    key = jax.random.PRNGKey(seed + 10)
    want = np.asarray(jq.qsgd_sample(key, jp))
    got = tq.qsgd_sample(convert.key(key, "cpu"), tp).numpy()
    np.testing.assert_allclose(got, want, rtol=FN_RTOL, atol=0)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sign_compress_is_binary_and_matches_reference(seed):
    g = _grad_like(seed, (3, 257))
    got = tq.sign_compress(torch.tensor(g)).numpy()
    for row, out in zip(g, got):
        want = np.asarray(jq.sign_compress(jnp.asarray(row)))
        np.testing.assert_array_equal(np.sign(out), np.sign(want))
        assert out[3] > 0                                     # zero maps to +1
        assert _ulp_diff(out, want).max() <= SUM_MAX_ULP       # the scale mean|g|
        assert len(np.unique(np.abs(out))) == 1


@pytest.mark.parametrize("seed,d,k", [(0, 64, 10), (1, 100, 1), (2, 33, 33), (3, 50, 70)])
def test_topk_compress_takes_lax_top_k_set_at_ties(seed, d, k):
    """Integer-valued inputs: many tied magnitudes, zeros among them; the
    kept set is ``lax.top_k``'s (lower index first at a tie), values exact."""
    rng = np.random.default_rng(seed)
    g = rng.integers(-3, 4, (4, d)).astype(np.float32)
    got = tq.topk_compress(torch.tensor(g), k).numpy()
    want = np.stack([np.asarray(jq.topk_compress(jnp.asarray(r), k)) for r in g])
    np.testing.assert_array_equal(got, want)
    idx = tq.topk_indices(torch.tensor(g), k).numpy()
    jidx = np.stack([np.asarray(jax.lax.top_k(jnp.abs(jnp.asarray(r)), min(k, d))[1])
                     for r in g])
    np.testing.assert_array_equal(idx, jidx)


@pytest.mark.parametrize("seed,d,k", [(0, 64, 10), (1, 1000, 7), (2, 20, 20)])
def test_randk_compress_matches_reference(seed, d, k):
    g = _grad_like(seed, (d,))
    key = jax.random.PRNGKey(seed)
    want = np.asarray(jq.randk_compress(key, jnp.asarray(g), k))
    got = tq.randk_compress(convert.key(key, "cpu"), torch.tensor(g), k).numpy()
    np.testing.assert_array_equal(got, want)


def test_bit_costs_match_reference():
    assert tq.FLOAT_BITS == jq.FLOAT_BITS == 32
    for d in (1, 2, 3, 1472, 28160, 2 ** 20 + 1):
        assert tq.sign_bits(d) == jq.sign_bits(d)
        assert tq.dense_bits(d) == jq.dense_bits(d)
        for k in (1, max(d // 10, 1), d):
            assert tq.topk_bits(d, k) == jq.topk_bits(d, k)


# ---------------------------------------------------------------------------
# CFLTask.
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ref():
    key = jax.random.PRNGKey(0)
    train, test = j_make_synthetic(key, n_train=400, n_test=100, hw=HW, noise=0.4)
    shards = j_partition(jax.random.fold_in(key, 1), train, N_CLIENTS, SHARD)
    net = j_make_mlp(HW * HW, (WIDTH,))
    task, theta0 = j_make_cfl_task(net, jax.random.fold_in(key, 2), test.x, test.y,
                                   local_epochs=2, batch_size=32, local_lr=3e-3)
    ttask, ttheta0 = convert.cfl_task(theta0, test.x, test.y, dims=DIMS, device="cpu",
                                      local_epochs=2, batch_size=32, local_lr=3e-3)
    return {"key": key, "shards": shards, "task": task, "theta0": theta0, "ttask": ttask,
            "ttheta0": ttheta0, "tshards": convert.dataset(shards.x, shards.y, "cpu")}


def test_convert_carries_theta0_and_refuses_a_wrong_width(ref):
    np.testing.assert_array_equal(ref["ttheta0"].numpy(), np.asarray(ref["theta0"]))
    assert ref["ttask"].d == ref["task"].d == 1472
    with pytest.raises(ValueError):
        convert.cfl_task(np.zeros(100, np.float32), np.zeros((1, HW, HW, 1), np.float32),
                         np.zeros(1, np.int32), dims=DIMS, device="cpu")


def test_make_cfl_task_draws_the_reference_theta0_to_normal_ulp_bound():
    """The port's own Kaiming draw: ``prng.normal`` against
    ``jax.random.normal`` (its bound, 128 ulp, is test_torch_prng's)."""
    key = jax.random.PRNGKey(0)
    _, theta0 = j_make_cfl_task(j_make_mlp(HW * HW, (WIDTH,)), jax.random.fold_in(key, 2),
                                None, None)
    task, ttheta0 = t_make_cfl_task(t_make_mlp(HW * HW, (WIDTH,), device="cpu"),
                                    prng.fold_in(prng.PRNGKey(0, device="cpu"), 2), None, None)
    assert task.d == ttheta0.shape[0] == 1472
    assert _ulp_diff(ttheta0.numpy(), np.asarray(theta0)).max() <= 128
    np.testing.assert_array_equal(np.sign(ttheta0.numpy()), np.sign(np.asarray(theta0)))


def test_cfl_local_train_matches_reference(ref):
    """Same model estimates, shards and keys: deltas within DELTA_ATOL.
    The batches are drawn on the unsplit key (``MaskTask`` splits it)."""
    task, ttask = ref["task"], ref["ttask"]
    sh, tsh = ref["shards"], ref["tshards"]
    rng = np.random.default_rng(3)
    theta = (np.asarray(ref["theta0"])[None]
             + 0.01 * rng.standard_normal((N_CLIENTS, task.d))).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(5), N_CLIENTS)
    want = np.asarray(jax.vmap(task.local_train)(jnp.asarray(theta), sh.x, sh.y, keys))
    got = ttask.local_train(torch.tensor(theta), tsh.x, tsh.y, convert.key(keys, "cpu"))
    print(f"CFL local_train max |delta_port - delta_ref|: {np.abs(got.numpy() - want).max():.3e}")
    np.testing.assert_allclose(got.numpy(), want, atol=DELTA_ATOL, rtol=0)
    jt = dataclasses.replace(task, batch_size=1000)          # one full batch per epoch
    tt = dataclasses.replace(ttask, batch_size=1000)
    want = np.asarray(jax.vmap(jt.local_train)(jnp.asarray(theta), sh.x, sh.y, keys))
    got = tt.local_train(torch.tensor(theta), tsh.x, tsh.y, convert.key(keys, "cpu"))
    np.testing.assert_allclose(got.numpy(), want, atol=DELTA_ATOL, rtol=0)
    assert ttask.evaluate(torch.tensor(theta[0])) == task.evaluate(jnp.asarray(theta[0]))


# ---------------------------------------------------------------------------
# The uplink, the aggregator and the relay, given the same payload.
# ---------------------------------------------------------------------------


def _fixed_gap(kt, sel, qb, pb, n_is, ell):
    """The reference's top-2 gap of logW + gumbel per block (one client,
    conveyed sample ``ell``)."""
    skey, sk = jm.sample_key(kt, ell), jm.sample_key(sel, ell)
    ids = jnp.arange(qb.shape[0])
    u = jax.vmap(lambda b: jm._block_candidates(skey, b, n_is, qb.shape[1]))(ids)
    x = (u < j_clip01(pb)[:, None, :]).astype(jnp.float32)
    a, b = j_coeffs(qb, pb)
    gu = jax.vmap(lambda b: jax.random.uniform(jax.random.fold_in(sk, b), (n_is,)))(ids)
    score = np.asarray(jm.default_logw(x, a, b) - jnp.log(-jnp.log(jnp.clip(gu, 1e-12,
                                                                            1.0 - 1e-12))))
    top2 = np.sort(score, axis=-1)[:, -2:]
    return top2[:, 1] - top2[:, 0]


def _ctxs(seed, n, d, active):
    kt = jax.random.fold_in(jax.random.PRNGKey(seed), 3)
    nb = -(-d // BLOCK)
    jplan = jch.BlockPlan(size=BLOCK, n_blocks=nb, seg_ids=None, overhead_bits=0.0)
    tplan = BlockPlan(size=BLOCK, n_blocks=nb, seg_ids=None, overhead_bits=0.0)
    jctx = jch.RoundContext(t=0, key=kt, n_clients=n, d=d, active=active, plan=jplan)
    tctx = tch.RoundContext(t=0, key=convert.key(kt, "cpu"), n_clients=n, d=d, active=active,
                            plan=tplan)
    return jctx, tctx


@pytest.mark.parametrize("seed,n,d,active,n_samples", [
    (0, 5, 1472, None, 1), (1, 5, 1001, None, 2), (2, 5, 1472, [0, 2, 4], 1),
    (3, 10, 700, None, 3)])
def test_quantized_uplink_and_aggregator_match_reference(seed, n, d, active, n_samples):
    """The reference's payload: K within SUM_MAX_ULP, indices equal outside
    near-ties, g_hat within K's rounding where the indices agree, bits
    equal; the aggregator on the same g_hat is bit-identical."""
    active = np.arange(n) if active is None else np.asarray(active)
    payload = _grad_like(seed, (len(active), d))
    jctx, tctx = _ctxs(seed, n, d, active)
    jidx, jK, jg, jbits = jch.QuantizedMRCUplink(n_is=N_IS, n_samples=n_samples)._transmit(
        jctx, jnp.asarray(payload), None)
    up = tch.QuantizedMRCUplink(n_is=N_IS, n_samples=n_samples)
    tidx, tK, tg, tbits = up._transmit(tctx, torch.tensor(payload), None)
    assert tbits == jbits == len(active) * (n_samples * -(-d // BLOCK) * math.log2(N_IS) + 32)
    assert _ulp_diff(tK.numpy(), np.asarray(jK)).max() <= SUM_MAX_ULP
    jidx, tidx = np.asarray(jidx), tidx.numpy()
    assert tidx.shape == jidx.shape == (len(active), n_samples, -(-d // BLOCK))
    sels = jax.vmap(lambda i: jax.random.fold_in(jax.random.fold_in(jctx.key, 2), i))(
        jnp.asarray(active))
    mism, agree = 0, np.ones((len(active), d), bool)
    for c in range(len(active)):
        qb = jch.to_blocks(jq.stochastic_sign(jnp.asarray(payload[c]), temperature=jK[c]).q,
                           BLOCK)
        for ell in range(n_samples):
            bad = np.nonzero(tidx[c, ell] != jidx[c, ell])[0]
            if len(bad):
                gap = _fixed_gap(jctx.key, sels[c], qb, jnp.full(qb.shape, 0.5), N_IS, ell)
                assert (gap[bad] < NEAR_TIE).all(), (c, ell, bad, gap[bad])
                mism += len(bad)
                for blk in bad:
                    agree[c, blk * BLOCK:(blk + 1) * BLOCK] = False
    print(f"index mismatches at near-ties: {mism} of {tidx.size}")
    np.testing.assert_allclose(tg.numpy()[agree], np.asarray(jg)[agree], rtol=1e-6, atol=0)
    # The aggregator as the reference engine runs it (jitted, the mean pinned
    # by the round's pin token; the mean is the sum times the float32
    # reciprocal of the count) on the same g_hat: bit-identical.
    th0 = np.linspace(-1, 1, d).astype(np.float32)

    def agg(th, g, tok):
        u = JMeanDelta(0.5)(dataclasses.replace(jctx, pin_token=tok), th, g)
        return u.delta, u.theta

    jdelta, jtheta = jax.jit(agg)(jnp.asarray(th0), jg, jnp.zeros((), jnp.int32))
    tup = TMeanDelta(0.5)(tctx, torch.tensor(th0), torch.tensor(np.asarray(jg)))
    np.testing.assert_array_equal(tup.delta.numpy(), np.asarray(jdelta))
    np.testing.assert_array_equal(tup.theta.numpy(), np.asarray(jtheta))
    assert tup.lr == JMeanDelta(0.5)(jctx, jnp.asarray(th0), jg).lr == 0.5
    g, bits, state = up.step_up(tctx, tch.EMPTY_STATE, torch.tensor(payload), None)
    assert bits == tbits and state == tch.EMPTY_STATE
    np.testing.assert_array_equal(g.numpy(), tg.numpy())


def test_quantized_uplink_is_one_batched_encode(monkeypatch):
    """The whole cohort goes through one ``mrc_fixed_encode`` call per
    conveyed sample, at (n_act, B, S): the shape the card's fused kernel
    takes.  The unfused route it replaced (the encoder's plain version
    with ``logw_fn=ops.mrc_logw``) weighs (n_act * B, n_is, S) candidate
    rows in one ``mrc_logw`` call per sample, with the same indices."""
    from repro_torch.kernels import mrc_weights, ops
    fused, calls = [], []
    real_fused, real = ops.mrc_fixed_encode, ops.mrc_logw
    monkeypatch.setattr(ops, "mrc_fixed_encode",
                        lambda *args: fused.append(args[2].shape) or real_fused(*args))
    monkeypatch.setattr(ops, "mrc_logw", lambda x, a, b: calls.append(x.shape) or real(x, a, b))
    _, tctx = _ctxs(0, 5, 1472, np.arange(5))
    payload = torch.tensor(_grad_like(0, (5, 1472)))
    idx = tch.QuantizedMRCUplink(n_is=N_IS, n_samples=2)._transmit(tctx, payload, None)[0]
    assert fused == [(5, 92, BLOCK)] * 2 and calls == []
    monkeypatch.setattr(ops, "mrc_fixed_encode", lambda *args: mrc_weights.mrc_fixed_encode_ref(
        *args, logw_fn=ops.mrc_logw))
    unfused = tch.QuantizedMRCUplink(n_is=N_IS, n_samples=2)._transmit(tctx, payload, None)[0]
    assert calls == [(5 * 92, N_IS, BLOCK)] * 2
    assert torch.equal(idx, unfused)


def test_relay_books_side_information(ref):
    n, d = 5, 1472
    jctx, tctx = _ctxs(0, n, d, np.arange(n))
    th = np.linspace(-1, 1, d).astype(np.float32)
    for side in (0.0, 32):
        jres = jch.IndexRelayDownlink(n_is=N_IS, side_info_bits=side).distribute(
            jctx, jch.ServerUpdate(theta=jnp.asarray(th)), None, None)
        tres = tch.IndexRelayDownlink(n_is=N_IS, side_info_bits=side).distribute(
            tctx, tch.ServerUpdate(theta=torch.tensor(th)), None, None)
        assert tres.bits == jres.bits == n * (n - 1) * (92 * 4 + side)
        np.testing.assert_array_equal(tres.theta_hat.numpy(), np.asarray(jres.theta_hat))


# ---------------------------------------------------------------------------
# Registry, whole runs and the entry points.
# ---------------------------------------------------------------------------


def test_cfl_spec_is_the_reference_scheme():
    js, ts = j_cfl_spec(n_is=32, n_ul=2, block_size=8, server_lr=0.5), \
        treg.cfl_spec(n_is=32, n_ul=2, block_size=8, server_lr=0.5)
    assert ts.name == js.name == "BiCompFL-GR-CFL"
    assert (ts.uplink.n_is, ts.uplink.n_samples, ts.uplink.side_info_bits) == \
        (js.uplink.n_is, js.uplink.n_samples, js.uplink.side_info_bits)
    assert (ts.downlink.n_is, ts.downlink.n_samples, ts.downlink.side_info_bits,
            ts.downlink.broadcast_shareable) == \
        (js.downlink.n_is, js.downlink.n_samples, js.downlink.side_info_bits,
         js.downlink.broadcast_shareable)
    assert ts.aggregator.server_lr == js.aggregator.server_lr == 0.5
    assert ts.allocation.block_size == js.allocation.block_size == 8
    assert ts.sync_period == js.sync_period == 0


def test_no_channel_or_factory_takes_a_logw_fn():
    """The importance weights always go through ``ops.mrc_logw``: no
    channel field and no registry or federator parameter reroutes them."""
    from repro_torch.fl import federator
    for cls in (tch.MRCFixedChannel, tch.MRCBroadcastDownlink, tch.MRCPrivateDownlink,
                tch.SplitBlockDownlink, tch.QuantizedMRCUplink):
        assert "logw_fn" not in {f.name for f in dataclasses.fields(cls)}, cls
    for fn in (treg.bicompfl_spec, treg.cfl_spec):
        assert "logw_fn" not in inspect.signature(fn).parameters
    for cfg in (federator.BiCompFLConfig, federator.CFLConfig):
        assert not {"logw_fn", "chunk"} & {f.name for f in dataclasses.fields(cfg)}


class _JIdx(jch.QuantizedMRCUplink):
    def step_up(self, ctx, state, payload, priors):
        idxs, _, g_hat, bits = self._transmit(ctx, payload, priors)
        jax.debug.callback(lambda i: self.log.append(np.asarray(i)), idxs)
        return g_hat, bits, state


class _TIdx(tch.QuantizedMRCUplink):
    def step_up(self, ctx, state, payload, priors):
        idxs, _, g_hat, bits = self._transmit(ctx, payload, priors)
        self.log.append(idxs.numpy())
        return g_hat, bits, state


@pytest.mark.parametrize("n_ul,server_lr", [(1, 1.0), (2, 0.5)])
def test_cfl_run_matches_reference(ref, n_ul, server_lr):
    """3 rounds, 5 clients, n_is 16, blocks of 16: bits and the meter equal
    every round, every uplink index equal, theta and theta_hat within
    THETA_ATOL, accuracy within ACC_BAND."""
    jspec = j_cfl_spec(n_is=N_IS, n_ul=n_ul, server_lr=server_lr)
    tspec = treg.cfl_spec(n_is=N_IS, n_ul=n_ul, server_lr=server_lr)
    jspec.uplink = _JIdx(n_is=N_IS, n_samples=n_ul)
    tspec.uplink = _TIdx(n_is=N_IS, n_samples=n_ul)
    jspec.uplink.log, tspec.uplink.log = [], []
    jout = JEngine(ref["task"], jspec).run(ref["shards"], ref["theta0"], rounds=ROUNDS,
                                           seed=0, eval_every=1, mode="host")
    tout = TEngine(ref["ttask"], tspec).run(ref["tshards"], ref["ttheta0"], rounds=ROUNDS,
                                            seed=0, eval_every=1)
    assert [h["cum_bits"] for h in tout["history"]] == [h["cum_bits"] for h in jout["history"]]
    assert tout["meter"] == jout["meter"]
    per_round = N_CLIENTS * (n_ul * 92 * 4 + 32) * (1 + (N_CLIENTS - 1))
    assert tout["meter"]["total_bits"] == ROUNDS * per_round
    assert len(tspec.uplink.log) == len(jspec.uplink.log) == ROUNDS
    for r, (ti, ji) in enumerate(zip(tspec.uplink.log, jspec.uplink.log)):
        np.testing.assert_array_equal(ti, ji, err_msg=f"round {r}")
    dt = np.abs(tout["theta"].numpy() - np.asarray(jout["theta"])).max()
    print(f"CFL run: max |theta_port - theta_ref| {dt:.3e}")
    np.testing.assert_allclose(tout["theta"].numpy(), np.asarray(jout["theta"]),
                               atol=THETA_ATOL, rtol=0)
    np.testing.assert_allclose(tout["theta_hat"].numpy(), np.asarray(jout["theta_hat"]),
                               atol=THETA_ATOL, rtol=0)
    for jh, th in zip(jout["history"], tout["history"]):
        assert abs(jh["acc"] - th["acc"]) <= ACC_BAND, (jh, th)


def test_run_bicompfl_cfl_matches_reference(ref):
    jout = j_run_cfl(ref["task"], ref["theta0"], ref["shards"],
                     JCFLConfig(n_is=N_IS, rounds=2, eval_every=2))
    tout = t_run_cfl(ref["ttask"], ref["ttheta0"], ref["tshards"],
                     TCFLConfig(n_is=N_IS, rounds=2, eval_every=2))
    assert tout["meter"] == jout["meter"]
    assert [h["round"] for h in tout["history"]] == [2]
    np.testing.assert_allclose(tout["theta"].numpy(), np.asarray(jout["theta"]),
                               atol=THETA_ATOL, rtol=0)


def test_cfl_entry_point_prints_the_reference_bits(capsys):
    """The example at full width (d = 28160, 10 clients), 3 rounds on the
    CPU: the reference's bpp for each scheme, exactly.  Two threads: the
    CFL encode's int64 threefry is memory-bound, and the suite runs several
    workers on one machine, where more threads only contend."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(2, threads))
    try:
        cfl_gradient_compression.main(["--device", "cpu", "--rounds", "3"])
    finally:
        torch.set_num_threads(threads)
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 3
    assert out[0].startswith("BiCompFL-GR-CFL") and "bpp 5.011364" in out[0] \
        and "uplink 0.501136, downlink 4.510227, bc 0.952159; 4233600 bits" in out[0]
    assert out[1].startswith("doublesqueeze") and "bpp 2.002273" in out[1]
    assert out[2].startswith("fedavg") and "bpp 64.000000" in out[2]
    if not torch.cuda.is_available():        # the default device is the card
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cfl_gradient_compression.main([])
