"""The port's MRC codec and its ``mrc_logw`` kernel route against the reference.

Integer outputs (indices, samples, block plans) must match exactly; float
outputs within a tolerance stated where it is used.  The CUDA kernel itself
runs only on the card: its tests are in ``test_torch_cuda.py``.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.core import bernoulli as jb
from repro.core import blocks as jblocks
from repro.core import mrc as jm
from repro.kernels import ops as jops
from repro_torch import convert
from repro_torch.core import bernoulli as tb
from repro_torch.core import blocks as tblocks
from repro_torch.core import mrc as tm
from repro_torch.kernels import ops as tops
from repro_torch.kernels.mrc_weights import mrc_logw_ref

# logW sums S products of a (|a| up to ~28 after the 1e-6 clip) in another
# order than XLA's dot: float32 rounding of an S-term sum, not an error.
LOGW_RTOL, LOGW_ATOL = 1e-6, 1e-5
# Gumbel-max ties: a mismatched index is allowed only where the reference's
# top-2 gap in logW + gumbel is below this (float noise of the two sums).
NEAR_TIE = 1e-4


def _qp(rng, shape, spread=0.1):
    q = rng.uniform(0.15, 0.85, shape).astype(np.float32)
    p = np.clip(q + spread * rng.standard_normal(shape), 0.05, 0.95).astype(np.float32)
    return q, p


def _logw_inputs(rng, nb, nis, s):
    q, p = _qp(rng, (nb, s))
    a, b = jb.log_ratio_coeffs(jnp.asarray(q), jnp.asarray(p))
    x = (rng.uniform(size=(nb, nis, s)) < p[:, None, :]).astype(np.float32)
    return x, np.asarray(a), np.asarray(b)


@pytest.mark.parametrize("shape", [(2, 128, 128), (3, 64, 256), (7, 48, 100), (1, 5, 3)])
def test_mrc_logw_ref_matches_reference(shape):
    """Aligned and ragged (NB, NIS, S) against the Pallas kernel (interpret
    mode, its own padding) and the jnp default."""
    x, a, b = _logw_inputs(np.random.default_rng(sum(shape)), *shape)
    got = mrc_logw_ref(torch.tensor(x), torch.tensor(a), torch.tensor(b)).numpy()
    pallas = np.asarray(jops.mrc_logw(jnp.asarray(x), jnp.asarray(a), jnp.asarray(b),
                                      interpret=True))
    plain = np.asarray(jm.default_logw(jnp.asarray(x), jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_allclose(got, pallas, rtol=LOGW_RTOL, atol=LOGW_ATOL)
    np.testing.assert_allclose(got, plain, rtol=LOGW_RTOL, atol=LOGW_ATOL)


def test_ops_mrc_logw_cpu_takes_plain_version_and_counts_nothing():
    x, a, b = (torch.tensor(v) for v in _logw_inputs(np.random.default_rng(0), 3, 16, 40))
    before = tops.mrc_logw.launches
    np.testing.assert_array_equal(tops.mrc_logw(x, a, b).numpy(),
                                  mrc_logw_ref(x, a, b).numpy())
    assert tops.mrc_logw.launches == before
    assert tops.mrc_logw_fn() is tops.mrc_logw


def test_ops_mrc_logw_refuses_other_devices():
    """Any device but cpu, meta and cuda is refused; meta tensors take the
    plain route (only shapes flow: the dry run's trace)."""
    x = torch.empty(2, 4, 8, device="meta")
    a = torch.empty(2, 8, device="meta")
    before = tops.mrc_logw.launches
    out = tops.mrc_logw(x, a, a)
    assert out.device.type == "meta" and out.shape == (2, 4)
    assert tops.mrc_logw.launches == before
    with pytest.raises(ValueError, match="cpu, meta or cuda"):
        tops._route(tops.mrc_logw, None, None, types.SimpleNamespace(device=torch.device("xpu")))


def test_bernoulli_helpers_match_reference():
    rng = np.random.default_rng(3)
    q = rng.uniform(0, 1, 500).astype(np.float32)
    q[:4] = [0.0, 1.0, 1e-9, 1 - 1e-9]
    p = rng.uniform(0, 1, 500).astype(np.float32)
    tq, tp = torch.tensor(q), torch.tensor(p)
    np.testing.assert_array_equal(tb.clip01(tq).numpy(), np.asarray(jb.clip01(q)))
    # transcendental functions: XLA's and torch's differ by an ulp or two
    for got, ref in [(tb.bern_kl(tq, tp), jb.bern_kl(q, p)),
                     (tb.inv_sigmoid(tq), jb.inv_sigmoid(q)),
                     *zip(tb.log_ratio_coeffs(tq, tp), jb.log_ratio_coeffs(q, p))]:
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("d,size", [(28160, 128), (1000, 64), (7, 16)])
def test_fixed_allocation_plan_matches_reference(d, size):
    assert tblocks.FixedAllocation(size).plan(None, d) == \
        jblocks.FixedAllocation(size).plan(None, d)


def _encode_both(seed, B, S, n_is, n_clients=None):
    """Reference (vmapped over clients when batched) and port encodes."""
    rng = np.random.default_rng(seed)
    shape = (B, S) if n_clients is None else (n_clients, B, S)
    q, p = _qp(rng, shape)
    k = jax.random.PRNGKey(seed)
    if n_clients is None:
        sk = jax.random.fold_in(k, 3)
        r = jm.encode_fixed(k, sk, jnp.asarray(q), jnp.asarray(p), n_is=n_is)
    else:
        sk = jax.random.split(jax.random.fold_in(k, 3), n_clients)
        r = jax.vmap(lambda s_, q_, p_: jm.encode_fixed(k, s_, q_, p_, n_is=n_is))(
            sk, jnp.asarray(q), jnp.asarray(p))
    t = tm.encode_fixed(convert.key(k, "cpu"), convert.key(sk, "cpu"),
                        torch.tensor(q), torch.tensor(p), n_is=n_is)
    return r, t, (k, sk, q, p)


def _near_tie_gap(k, sk, q, p, n_is):
    """Reference's top-2 gap of logW + gumbel per block (single client)."""
    B, S = q.shape
    a, b = jb.log_ratio_coeffs(jnp.asarray(q), jnp.asarray(p))
    u = jax.vmap(lambda j: jm._block_candidates(k, j, n_is, S))(jnp.arange(B))
    x = (u < jb.clip01(jnp.asarray(p))[:, None, :]).astype(jnp.float32)
    gu = jax.vmap(lambda j: jax.random.uniform(jax.random.fold_in(sk, j), (n_is,)))(
        jnp.arange(B))
    score = np.asarray(jm.default_logw(x, a, b) - jnp.log(-jnp.log(
        jnp.clip(gu, 1e-12, 1.0 - 1e-12))))
    top2 = np.sort(score, axis=-1)[:, -2:]
    return top2[:, 1] - top2[:, 0]


@pytest.mark.parametrize("seed,B,S,n_is", [(0, 6, 32, 32), (1, 10, 128, 64),
                                           (2, 5, 100, 48), (3, 3, 7, 256)])
def test_encode_fixed_matches_reference(seed, B, S, n_is):
    r, t, (k, sk, q, p) = _encode_both(seed, B, S, n_is)
    ji, ti = np.asarray(r.indices), t.indices.numpy()
    diff = ji != ti
    if diff.any():
        gap = _near_tie_gap(k, sk, q, p, n_is)
        assert (gap[diff] < NEAR_TIE).all(), (gap[diff], ji[diff], ti[diff])
    print(f"encode_fixed near-tie mismatches: {int(diff.sum())} of {diff.size}")
    same = ~diff
    np.testing.assert_array_equal(t.sample.numpy()[same], np.asarray(r.sample)[same])


def test_encode_fixed_cohort_batch_matches_vmapped_reference():
    """One batched encode of 4 clients x 9 blocks == the reference's vmap."""
    r, t, _ = _encode_both(5, 9, 64, 32, n_clients=4)
    ji, ti = np.asarray(r.indices), t.indices.numpy()
    print(f"cohort encode near-tie mismatches: {int((ji != ti).sum())} of {ji.size}")
    assert (ji == ti).mean() >= 0.99
    np.testing.assert_array_equal(t.sample.numpy(), np.asarray(r.sample))


@settings(max_examples=10, deadline=None)
@given(seed=st.integers(0, 2 ** 31 - 1), B=st.integers(1, 6), S=st.integers(1, 70),
       n_is=st.sampled_from([2, 16, 64]))
def test_decode_of_encode_is_the_sample(seed, B, S, n_is):
    q, p = _qp(np.random.default_rng(seed), (B, S))
    key = torch.tensor([seed, 7])
    res = tm.encode_fixed(key, torch.tensor([1, seed]), torch.tensor(q), torch.tensor(p),
                          n_is=n_is)
    dec = tm.decode_fixed(key, res.indices, torch.tensor(p), n_is=n_is)
    np.testing.assert_array_equal(dec.numpy(), res.sample.numpy())
    assert res.indices.min() >= 0 and res.indices.max() < n_is


def test_decode_fixed_matches_reference_on_reference_indices():
    rng = np.random.default_rng(8)
    q, p = _qp(rng, (8, 96))
    k = jax.random.PRNGKey(8)
    idx = jnp.asarray(rng.integers(0, 64, 8), jnp.int32)
    ref = jm.decode_fixed(k, idx, jnp.asarray(p), n_is=64)
    got = tm.decode_fixed(convert.key(k, "cpu"), torch.tensor(np.asarray(idx)),
                          torch.tensor(p), n_is=64)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_transmit_and_receive_match_reference():
    rng = np.random.default_rng(9)
    q, p = _qp(rng, (5, 64))
    k, sk = jax.random.PRNGKey(9), jax.random.PRNGKey(10)
    ji, jq = jm.transmit_fixed(k, sk, jnp.asarray(q), jnp.asarray(p), n_is=32, n_samples=3)
    tk, tsk = convert.key(k, "cpu"), convert.key(sk, "cpu")
    ti, tq = tm.transmit_fixed(tk, tsk, torch.tensor(q), torch.tensor(p), n_is=32,
                               n_samples=3)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    back = tm.receive_fixed(tk, ti, torch.tensor(p), n_is=32)
    np.testing.assert_array_equal(back.numpy(), np.asarray(
        jm.receive_fixed(k, ji, jnp.asarray(p), n_is=32)))


@pytest.mark.parametrize("seed", [0, 1])
def test_key_schedule_matches_reference(seed):
    base = jax.random.PRNGKey(seed)
    tbase = convert.key(base, "cpu")
    for ref, got in [(jm.round_key(base, 3), tm.round_key(tbase, 3)),
                     (jm.client_key(base, 4), tm.client_key(tbase, 4)),
                     (jm.sample_key(base, 2), tm.sample_key(tbase, 2))]:
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref).astype(np.int64))
