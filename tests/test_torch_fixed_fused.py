"""The fused fixed-block encoder (``ops.mrc_fixed_encode``) on the CPU.

Held here, where no card is:

* ``mrc_fixed_encode_ref`` -- the plain version, which is the CPU route of
  ``core.mrc.encode_fixed`` and the oracle of the keyed kernel on the card
  -- against the JAX package's ``repro.core.mrc.encode_fixed`` on the same
  keys and inputs: one candidate key shared by the clients and one per
  client, ``(C, 2)`` and ``(2,)`` selection keys, ragged block counts, S of
  7, 16 and 128, 33 to 256 candidates, and the CFL uplink's Ber(1/2) prior
  with 10 clients.  Indices and samples exactly equal, logW within the
  tolerance stated below;
* ``encode_fixed``'s routing: no ``logw_fn`` is the fused encoder, a
  ``logw_fn`` the unfused route through it, with the same indices; every
  fixed-block channel encodes through the fused encoder, and pointed at
  the unfused route gives the same indices;
* the kernel's per-row sum order (``csrc/mrc_row.cuh``), emulated in
  float32: within rounding of the plain version, with its indices equal to
  the plain route's outside near-ties.

The CUDA kernel itself runs only on the card (``test_torch_cuda.py``).
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bernoulli as jb
from repro.core import mrc as jm
from repro_torch import convert, prng
from repro_torch.core import mrc as tm
from repro_torch.core.bernoulli import clip01, log_ratio_coeffs
from repro_torch.core.blocks import BlockPlan
from repro_torch.fl import channels as tch
from repro_torch.kernels import build, mrc_weights as mw
from repro_torch.kernels import ops

# logW against the reference's, and the kernel's sum order against the
# plain version's: the same S + S float32 terms (x a and b; |a| up to ~28
# after the 1e-6 clip) summed in another order.  The rounding of a sum
# scales with the sum of its terms' magnitudes: held within 1e-6 of it
# (~16 ulp), far below any wrong or missing term.
SUM_RTOL, SUM_ATOL = 1e-6, 1e-6
# Gumbel-max near-ties: an index of the emulated kernel order may differ
# from the plain route's only where the plain top-2 gap is below this.
NEAR_TIE = 1e-4


def _qp(seed, shape, spread=0.1):
    rng = np.random.default_rng(seed)
    q = rng.uniform(0.05, 0.95, shape).astype(np.float32)
    p = np.clip(q + spread * rng.standard_normal(shape), 0.0, 1.0).astype(np.float32)
    return q, p


def _keys(seed, clients, key_kind, sel_kind):
    """Reference keys: the candidate key (2,) or (C, 2), the selection key
    (C, 2) or (2,)."""
    k = jax.random.PRNGKey(seed)
    ck = k if key_kind == "shared" else jax.vmap(lambda i: jm.client_key(k, i))(
        jnp.arange(clients))
    sel = jax.random.fold_in(k, 3)
    sk = sel if sel_kind == "one" else jax.random.split(sel, clients)
    return ck, sk


def _reference(ck, sk, q, p, n_is, key_kind, sel_kind):
    """The reference's encoder (vmapped over clients) and its logW on its
    own candidates, (N..., B) / (N..., B, S) / (N..., B, n_is)."""
    def one(k, s, q_, p_):
        res = jm.encode_fixed(k, s, q_, p_, n_is=n_is)
        n_blocks, size = q_.shape
        u = jax.vmap(lambda j: jm._block_candidates(k, j, n_is, size))(jnp.arange(n_blocks))
        x = (u < jb.clip01(p_)[:, None, :]).astype(jnp.float32)
        a, b = jb.log_ratio_coeffs(q_, p_)
        return res.indices, res.sample, jm.default_logw(x, a, b)

    q, p = jnp.asarray(q), jnp.asarray(p)
    if sel_kind == "one":
        out = one(ck, sk, q, p)
    else:
        out = jax.vmap(one, in_axes=(None if key_kind == "shared" else 0, 0, 0, 0))(
            ck, sk, q, p)
    return tuple(np.asarray(o) for o in out)


def _magnitude(a, b):
    """Sum of the magnitudes of logW's terms, (N..., B, 1): a bound on
    every candidate's (x in {0, 1})."""
    return (a.abs().sum(-1) + b.abs().sum(-1))[..., None].numpy()


def _assert_sums_close(got, want, a, b):
    err = np.abs(got.numpy() - want)
    assert np.all(err <= SUM_RTOL * _magnitude(a, b) + SUM_ATOL), err.max()


# (clients, B, S, n_is, candidate key, selection key); clients None: one
# (B, S) target with a (2,) selection key (GR-Reconst's broadcast).
CASES = [(3, 5, 7, 33, "shared", "clients"), (3, 5, 7, 33, "client", "clients"),
         (2, 9, 16, 64, "shared", "clients"), (2, 9, 16, 64, "client", "clients"),
         (4, 3, 128, 64, "shared", "clients"), (4, 3, 128, 64, "client", "clients"),
         (2, 2, 16, 256, "client", "clients"), (None, 7, 16, 256, "shared", "one"),
         (None, 3, 128, 33, "shared", "one")]


@pytest.mark.parametrize("clients,n_blocks,s,n_is,key_kind,sel_kind", CASES)
def test_plain_route_matches_reference(clients, n_blocks, s, n_is, key_kind, sel_kind):
    seed = n_blocks * 100 + s + n_is
    shape = (n_blocks, s) if clients is None else (clients, n_blocks, s)
    q, p = _qp(seed, shape)
    ck, sk = _keys(seed, clients or 1, key_kind, sel_kind)
    ji, js, jl = _reference(ck, sk, q, p, n_is, key_kind, sel_kind)
    tk, tsk = convert.key(ck, "cpu"), convert.key(sk, "cpu")
    a, b = log_ratio_coeffs(torch.tensor(q), torch.tensor(p))
    idx, sample, logw = mw.mrc_fixed_encode_ref(tk, tsk, clip01(torch.tensor(p)), a, b, n_is)
    assert idx.dtype == torch.int64 and tuple(idx.shape) == shape[:-1]
    assert tuple(sample.shape) == shape and tuple(logw.shape) == shape[:-1] + (n_is,)
    _assert_sums_close(logw, jl, a, b)
    np.testing.assert_array_equal(idx.numpy(), ji)
    np.testing.assert_array_equal(sample.numpy(), js)
    # the codec's entry point on the (N..., B, S) batch gives the same
    res = tm.encode_fixed(tk, tsk, torch.tensor(q), torch.tensor(p), n_is=n_is)
    assert torch.equal(res.indices, idx) and torch.equal(res.sample, sample)


def test_cfl_prior_of_one_half_with_ten_clients():
    """The CFL uplink's encode: stochastic-sign posteriors against Ber(1/2),
    10 clients on the common round key's candidates, blocks of 16, 256
    candidates, a ragged block count."""
    rng = np.random.default_rng(17)
    delta = rng.standard_normal((10, 37 * 16)).astype(np.float32)
    k_mean = np.abs(delta).mean(-1, keepdims=True) + np.float32(1e-12)
    q = np.clip(1 / (1 + np.exp(-delta / k_mean)), 1e-6, 1 - 1e-6).astype(np.float32)
    q = q.reshape(10, 37, 16)
    p = np.full_like(q, 0.5)
    ck, sk = _keys(17, 10, "shared", "clients")
    ji, js, jl = _reference(ck, sk, q, p, 256, "shared", "clients")
    tk, tsk = convert.key(ck, "cpu"), convert.key(sk, "cpu")
    a, b = log_ratio_coeffs(torch.tensor(q), torch.tensor(p))
    idx, sample, logw = ops.mrc_fixed_encode(tk, tsk, clip01(torch.tensor(p)), a, b, 256)
    _assert_sums_close(logw, jl, a, b)
    np.testing.assert_array_equal(idx.numpy(), ji)
    np.testing.assert_array_equal(sample.numpy(), js)


# ---------------------------------------------------------------------------
# Routing: the fused encoder by default, the logw_fn hook as the unfused route.
# ---------------------------------------------------------------------------


def test_encode_fixed_default_route_is_the_fused_encoder(monkeypatch):
    """``encode_fixed`` without a hook calls ``ops.mrc_fixed_encode`` once;
    with ``logw_fn=ops.mrc_logw`` it draws the candidates and weighs them in
    one call of the whole batch; both give the same indices and sample."""
    q, p = _qp(3, (4, 6, 40))
    key = prng.PRNGKey(5, device="cpu")
    sels = prng.split(prng.PRNGKey(6, device="cpu"), 4)
    calls, fused_calls = [], []

    def hook(x, a, b):
        calls.append(tuple(x.shape))
        return ops.mrc_logw(x, a, b)

    real = ops.mrc_fixed_encode
    monkeypatch.setattr(ops, "mrc_fixed_encode",
                        lambda *args: fused_calls.append(args[2].shape) or real(*args))
    fused = tm.encode_fixed(key, sels, torch.tensor(q), torch.tensor(p), n_is=16)
    hooked = tm.encode_fixed(key, sels, torch.tensor(q), torch.tensor(p), n_is=16,
                             logw_fn=hook)
    assert fused_calls == [torch.Size([4, 6, 40])]
    assert calls == [(24, 16, 40)]
    assert torch.equal(fused.indices, hooked.indices)
    assert torch.equal(fused.sample, hooked.sample)
    assert torch.equal(tm.decode_fixed(key, fused.indices, torch.tensor(p), n_is=16),
                       fused.sample)


def test_ops_mrc_fixed_encode_on_the_cpu_is_the_plain_version_and_counts_nothing():
    q, p = _qp(4, (3, 5, 24))
    a, b = log_ratio_coeffs(torch.tensor(q), torch.tensor(p))
    pc = clip01(torch.tensor(p))
    keys = tm.client_key(prng.PRNGKey(1, device="cpu"), torch.arange(3))
    sels = prng.split(prng.PRNGKey(2, device="cpu"), 3)
    before = ops.mrc_fixed_encode.launches
    got = ops.mrc_fixed_encode(keys, sels, pc, a, b, 32)
    want = mw.mrc_fixed_encode_ref(keys, sels, pc, a, b, 32)
    assert all(torch.equal(x, y) for x, y in zip(got, want))
    assert ops.mrc_fixed_encode.launches == before
    # meta tensors take the plain route (shapes only, no launch); any other
    # device but cpu and cuda is refused
    idx, sample, logw = ops.mrc_fixed_encode(keys.to("meta"), sels.to("meta"), pc.to("meta"),
                                             a.to("meta"), b.to("meta"), 32)
    assert sample.device.type == "meta" and sample.shape == pc.shape
    assert ops.mrc_fixed_encode.launches == before
    with pytest.raises(ValueError, match="cpu, meta or cuda"):
        ops._route(ops.mrc_fixed_encode, None, None,
                   types.SimpleNamespace(device=torch.device("xpu")))


def test_kernel_wrapper_refuses_cpu_tensors_and_bad_shapes():
    """The card's wrapper checks shapes and devices before any build."""
    pc = torch.full((2, 3, 16), 0.5)
    key, sels = prng.PRNGKey(0, device="cpu"), prng.split(prng.PRNGKey(1, device="cpu"), 2)
    with pytest.raises(ValueError, match="shape"):
        mw.mrc_fixed_encode_cuda(key, sels, pc, pc[:, :2], pc, 8)
    with pytest.raises(ValueError, match="shape"):
        mw.mrc_fixed_encode_cuda(key, sels, pc[0, 0], pc[0, 0], pc[0, 0], 8)
    with pytest.raises(ValueError, match="CUDA"):
        mw.mrc_fixed_encode_cuda(key, sels, pc, pc, pc, 8)


def _fixed_ctx(n, d, size, active=None):
    plan = BlockPlan(size=size, n_blocks=-(-d // size), seg_ids=None, overhead_bits=0.0)
    return tch.RoundContext(t=0, key=prng.PRNGKey(9, device="cpu"), n_clients=n, d=d,
                            active=np.arange(n) if active is None else active, plan=plan)


CHANNELS = {
    "GR uplink": lambda: tch.MRCFixedChannel(n_is=16, shared=True),
    "PR uplink": lambda: tch.MRCFixedChannel(n_is=16, shared=False),
    "CFL uplink": lambda: tch.QuantizedMRCUplink(n_is=16),
    "GR-Reconst downlink": lambda: tch.MRCBroadcastDownlink(n_is=16, n_samples=2),
    "PR downlink": lambda: tch.MRCPrivateDownlink(n_is=16, n_samples=2),
    "PR-SplitDL downlink": lambda: tch.SplitBlockDownlink(n_is=16),
}


@pytest.mark.parametrize("name", list(CHANNELS))
def test_every_fixed_block_channel_encodes_through_the_fused_encoder(name, monkeypatch):
    """Each fixed-block channel encodes through ``ops.mrc_fixed_encode``,
    one call per conveyed sample; pointed at the unfused route it replaced
    (the plain version with a u-fed ``logw_fn``, the measurement's before),
    the channel gives the same indices and outputs."""
    n, d = 4, 200
    rng = np.random.default_rng(len(name))
    payload = torch.tensor(rng.uniform(0.05, 0.95, (n, d)).astype(np.float32))
    priors = torch.tensor(rng.uniform(0.05, 0.95, (n, d)).astype(np.float32))
    fused_calls, calls = [], []
    real = ops.mrc_fixed_encode

    def hook(x, a, b):
        calls.append(tuple(x.shape))
        return ops.mrc_logw(x, a, b)

    routes = {"fused": lambda *args: fused_calls.append(args[2].shape) or real(*args),
              "unfused": lambda *args: mw.mrc_fixed_encode_ref(*args, logw_fn=hook)}
    outs = []
    for route in routes.values():
        monkeypatch.setattr(ops, "mrc_fixed_encode", route)
        chan, ctx = CHANNELS[name](), _fixed_ctx(n, d, 16)
        if isinstance(chan, tch.StatelessUplink):
            outs.append(chan._transmit(ctx, payload, priors))
        else:
            outs.append(chan._transmit(ctx, tch.ServerUpdate(theta=payload[0]), priors))
    assert len(fused_calls) == len(calls) == chan.n_samples
    assert all(c[1:] == (16, 16) for c in calls)
    assert torch.equal(outs[0][0], outs[1][0])
    assert all(torch.equal(x, y) for x, y in zip(outs[0][1:-1], outs[1][1:-1]))


# ---------------------------------------------------------------------------
# The kernel's per-row sum order (csrc/mrc_row.cuh), emulated in float32.
# ---------------------------------------------------------------------------


def test_both_forms_build_from_one_source_with_the_shared_headers():
    """The u-fed and keyed forms are one library, named by the hash of its
    source and of both headers it includes (an edit of the shared row order
    rebuilds it)."""
    assert [p.name for p in build.inputs("mrc_logw")] == \
        ["mrc_logw.cu", "common.cuh", "mrc_row.cuh"]
    assert "mrc_logw" in build.SOURCES


def group_lanes(s: int) -> int:
    """mrc_group_lanes: ceil(S/4) rounded up to a power of two, at most 32."""
    g = 1
    while g < -(-s // 4) and g < 32:
        g *= 2
    return g


def kernel_order_logw(x: np.ndarray, a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """logW in the kernel's order: lane l of a G-lane group adds chunks
    q = l, l + G, ... of four elements (past S: x = a = 0) in order, then an
    xor butterfly over the lanes; the b sum is the same with x = 1."""
    nb, nis, s = x.shape
    g, nq = group_lanes(s), -(-s // 4)
    pad = 4 * nq - s

    def rows(xx, aa):                      # xx (..., S), aa broadcast -> (...,)
        xs = np.pad(xx, [(0, 0)] * (xx.ndim - 1) + [(0, pad)]).astype(np.float32)
        as_ = np.pad(np.broadcast_to(aa, xx.shape),
                     [(0, 0)] * (xx.ndim - 1) + [(0, pad)]).astype(np.float32)
        lanes = np.zeros(xx.shape[:-1] + (g,), np.float32)
        for lane in range(g):
            for q in range(lane, nq, g):
                for e in range(4 * q, 4 * q + 4):
                    lanes[..., lane] = lanes[..., lane] + xs[..., e] * as_[..., e]
        off = g // 2
        while off:
            lanes = lanes + lanes[..., np.arange(g) ^ off]
            off //= 2
        return lanes[..., 0]

    bias = rows(np.ones_like(b), b)                          # (NB,)
    return rows(x, a[:, None, :]) + bias[:, None]


@pytest.mark.parametrize("s", [1, 3, 7, 16, 33, 100, 128, 300, 512])
def test_kernel_sum_order_is_within_rounding_of_the_plain_version(s):
    rng = np.random.default_rng(s)
    q, p = _qp(s, (6, s))
    a, b = log_ratio_coeffs(torch.tensor(q), torch.tensor(p))
    x = (rng.uniform(size=(6, 20, s)) < p[:, None, :]).astype(np.float32)
    got = kernel_order_logw(x, a.numpy(), b.numpy())
    want = mw.mrc_logw_ref(torch.tensor(x), a, b).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    assert np.all(np.abs(got - want) <= SUM_RTOL * _magnitude(a, b) + SUM_ATOL)
    assert group_lanes(s) in (1, 2, 4, 8, 16, 32) and group_lanes(s) * 4 >= min(s, 128)


@pytest.mark.parametrize("key_kind", ["shared", "client"])
@pytest.mark.parametrize("n_blocks,s,n_is", [(40, 16, 256), (11, 128, 64), (9, 7, 33)])
def test_kernel_order_indices_equal_the_plain_route_outside_near_ties(key_kind, n_blocks, s,
                                                                      n_is):
    """The keyed kernel's algorithm in plain torch: prng's candidates, logW
    in the kernel's order, the same Gumbel noise and argmax, the chosen
    row redrawn by uniform_at.  Indices differ from the plain route's only
    at near-ties (counted), and the sample is exact wherever they agree."""
    clients = 3
    q, p = _qp(n_blocks + s, (clients, n_blocks, s))
    a, b = log_ratio_coeffs(torch.tensor(q), torch.tensor(p))
    pc = clip01(torch.tensor(p))
    key = prng.PRNGKey(n_is, device="cpu")
    if key_kind == "client":
        key = tm.client_key(key, torch.arange(clients))
    sels = prng.split(prng.PRNGKey(n_is + 1, device="cpu"), clients)
    w_idx, w_sample, w_logw = mw.mrc_fixed_encode_ref(key, sels, pc, a, b, n_is)
    u = mw.block_candidates(key, n_blocks, n_is, s).expand(clients, n_blocks, n_is, s)
    x = (u < pc[..., None, :]).to(torch.float32)
    logw = kernel_order_logw(x.reshape(-1, n_is, s).numpy(), a.reshape(-1, s).numpy(),
                             b.reshape(-1, s).numpy()).reshape(clients, n_blocks, n_is)
    gumbel = mw.block_gumbel(sels, n_blocks, n_is)
    idx = torch.argmax(torch.tensor(logw) + gumbel, dim=-1)
    bkeys = mw.block_keys(key, n_blocks).expand(clients, n_blocks, 2)
    at = idx[..., None] * s + torch.arange(s)
    sample = (prng.uniform_at(bkeys, at) < pc).to(torch.float32)
    score = torch.sort(w_logw + gumbel, dim=-1).values
    gap = score[..., -1] - score[..., -2]
    diff = idx != w_idx
    print(f"{key_kind} ({clients}, {n_blocks}, {s}, {n_is}): {int(diff.sum())} near-tie "
          f"index mismatches of {diff.numel()}")
    assert bool((gap[diff] < NEAR_TIE).all())
    assert torch.equal(sample[~diff], w_sample[~diff])
