"""The port's CUDA kernels on the card, against their plain PyTorch versions.

Every test here needs an NVIDIA card and skips without one.  The file
imports neither ``jax`` nor ``repro``, so it also runs on a machine that has
only the port's dependencies:

    python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest``: ``tests/conftest.py`` imports JAX for the reference's
tests.)  The CPU tests in ``test_torch_mrc.py`` tie the plain versions to
the JAX reference.
"""
import types

import numpy as np
import pytest
import torch

from repro_torch import prng
from repro_torch.core import mrc
from repro_torch.core.bernoulli import clip01, log_ratio_coeffs
from repro_torch.kernels import bernoulli_kl as kl
from repro_torch.kernels import ops
from repro_torch.kernels.mrc_weights import mrc_logw_cuda, mrc_logw_ref
from repro_torch.kernels import segment_logw as sl
from repro_torch.kernels.segment_logw import segment_logw_cuda, segment_logw_ref

pytestmark = pytest.mark.cuda

# fp32 S-term sums in another order than the plain version's GEMV.
LOGW_RTOL, LOGW_ATOL = 1e-5, 1e-4
# KL and segment sums: fp32 terms summed in another order; the bound is
# relative to the sum of the terms' magnitudes (what the rounding scales
# with), ~100 ulp of it.
SUM_RTOL, SUM_ATOL = 1e-5, 1e-6


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (a CUDA kernel has no CPU mode)")
    return torch.device("cuda")


def _logw_inputs(nb, nis, s, seed, device):
    key = prng.PRNGKey(seed, device=device)
    ku, kq, kp = prng.split(key, 3)
    q = 0.15 + 0.7 * prng.uniform(kq, (nb, s))
    p = torch.clamp(q + 0.1 * prng.normal(kp, (nb, s)), 0.05, 0.95)
    x = (prng.uniform(ku, (nb, nis, s)) < p[:, None, :]).to(torch.float32)
    a, b = log_ratio_coeffs(q, p)
    return x, a, b


@pytest.mark.parametrize("shape", [(2200, 64, 128), (7, 48, 100), (5, 33, 7),
                                   (3, 1, 1), (4, 256, 4096), (17600, 256, 16),
                                   (9, 20, 33), (6, 70, 513)])
def test_mrc_logw_kernel_matches_plain(cuda, shape):
    x, a, b = _logw_inputs(*shape, seed=sum(shape), device=cuda)
    got = mrc_logw_cuda(x, a, b)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, mrc_logw_ref(x, a, b), rtol=LOGW_RTOL,
                               atol=LOGW_ATOL)


def test_mrc_logw_kernel_unaligned_view_takes_scalar_path(cuda):
    """x starting 4 bytes into its storage cannot use float4 loads."""
    x, a, b = _logw_inputs(6, 40, 129, seed=1, device=cuda)
    x1 = x.reshape(-1)[1:1 + 6 * 40 * 128].view(6, 40, 128)  # contiguous, offset 4 B
    a1 = a.reshape(-1)[1:1 + 6 * 128].view(6, 128)
    b1 = b.reshape(-1)[1:1 + 6 * 128].view(6, 128)
    assert x1.is_contiguous() and x1.data_ptr() % 16 != 0
    got = mrc_logw_cuda(x1, a1, b1)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, mrc_logw_ref(x1, a1, b1), rtol=LOGW_RTOL,
                               atol=LOGW_ATOL)


def test_ops_counts_kernel_launches(cuda):
    x, a, b = _logw_inputs(8, 16, 32, seed=2, device=cuda)
    before = ops.mrc_logw.launches
    got = ops.mrc_logw(x, a, b)
    ops.mrc_logw(x, a, b)
    assert ops.mrc_logw.launches == before + 2
    torch.testing.assert_close(got, mrc_logw_ref(x, a, b), rtol=LOGW_RTOL,
                               atol=LOGW_ATOL)


def test_kernel_wrapper_refuses_bad_input(cuda):
    x, a, b = _logw_inputs(4, 8, 16, seed=3, device=cuda)
    with pytest.raises(TypeError):
        mrc_logw_cuda(x.double(), a, b)
    with pytest.raises(ValueError):
        mrc_logw_cuda(x.transpose(1, 2), a, b)       # not contiguous
    with pytest.raises(ValueError):
        mrc_logw_cuda(x, a[:, :8].contiguous(), b)   # shape mismatch
    with pytest.raises(ValueError):
        mrc_logw_cuda(x, a.cpu(), b)                 # wrong device


def test_encode_on_card_matches_cpu_route(cuda):
    """Full-width cohort encode: kernel on the card vs plain on the CPU."""
    g = torch.Generator().manual_seed(7)
    q = 0.05 + 0.9 * torch.rand(10, 220, 128, generator=g)
    p = torch.clamp(q + 0.05 * torch.randn(10, 220, 128, generator=g), 0.05, 0.95)
    key = prng.PRNGKey(11, device="cpu")
    sels = prng.split(prng.PRNGKey(12, device="cpu"), 10)
    cpu = mrc.encode_fixed(key, sels, q, p, n_is=64)
    gpu = mrc.encode_fixed(key.to(cuda), sels.to(cuda), q.to(cuda), p.to(cuda), n_is=64)
    same = gpu.indices.cpu() == cpu.indices
    # transcendental functions round differently on the card: near-ties only
    assert same.to(torch.float32).mean() >= 0.99
    assert torch.equal(gpu.sample.cpu()[same], cpu.sample[same])
    dec = mrc.decode_fixed(key.to(cuda), gpu.indices, p.to(cuda), n_is=64)
    assert torch.equal(dec, gpu.sample)


def _assert_sums_close(got, want, scale):
    assert got.shape == want.shape
    assert bool(torch.isfinite(got).all())
    assert bool(((got - want).abs() <= SUM_RTOL * scale + SUM_ATOL).all()), \
        float((got - want).abs().max())


def _kl_scale(q, p):
    q, p = clip01(q), clip01(p)
    return (q * (torch.log(q) - torch.log(p))).abs() \
        + ((1 - q) * (torch.log1p(-q) - torch.log1p(-p))).abs()


@pytest.mark.parametrize("shape", [(10, 28160), (7, 3001), (3, 5), (1, 1), (4, 2048),
                                   (2200, 128), (1, 300000)])
def test_bernoulli_kl_kernels_match_plain(cuda, shape):
    gen = torch.Generator(device=cuda).manual_seed(sum(shape))
    q = torch.rand(shape, generator=gen, device=cuda)
    p = torch.rand(shape, generator=gen, device=cuda)
    q[0, 0], p[0, -1] = 0.0, 1.0                 # the 1e-6 clip
    sc = _kl_scale(q, p)
    n = shape[0]
    _assert_sums_close(kl.rows_cuda(q, p), kl.rows_ref(q, p), sc.sum(-1))
    _assert_sums_close(kl.total_cuda(q, p), kl.total_ref(q, p), sc.sum() / n)
    _assert_sums_close(kl.profile_cuda(q, p), kl.profile_ref(q, p), sc.sum(0) / n)


def test_bernoulli_kl_is_deterministic(cuda):
    gen = torch.Generator(device=cuda).manual_seed(1)
    q, p = (torch.rand(10, 28160, generator=gen, device=cuda) for _ in range(2))
    assert torch.equal(kl.total_cuda(q, p), kl.total_cuda(q, p))
    assert torch.equal(kl.profile_cuda(q, p), kl.profile_cuda(q, p))


def _segmentation(kind, d, rng):
    if kind == "single":
        return np.zeros(d, np.int32), 1
    if kind == "singletons":
        return np.arange(d, dtype=np.int32), d
    ids = np.sort(rng.integers(0, max(d // 7, 1), d)).astype(np.int32)
    if kind == "random":                         # consecutive ids
        ids = np.cumsum(np.r_[0, np.diff(ids) > 0]).astype(np.int32)
    ids -= ids[0]                                # "skipping": empty segments
    return ids, int(ids[-1]) + 1


@pytest.mark.parametrize("kind", ["random", "skipping", "single", "singletons"])
@pytest.mark.parametrize("clients,nis,d", [(10, 64, 28160), (3, 33, 1001), (2, 70, 513),
                                           (None, 1, 7)])
def test_segment_logw_kernel_matches_plain(cuda, kind, clients, nis, d):
    """u (NIS, D) shared by the clients; ``clients=None`` is one client's
    (D,) p, a, b."""
    rng = np.random.default_rng(d + nis)
    gen = torch.Generator(device=cuda).manual_seed(d)
    u = torch.rand(nis, d, generator=gen, device=cuda)
    shape = (d,) if clients is None else (clients, d)
    q, p = (torch.rand(shape, generator=gen, device=cuda) for _ in range(2))
    a, b = (t.contiguous() for t in log_ratio_coeffs(q, p))
    pc = clip01(p).contiguous()
    seg, n_seg = _segmentation(kind, d, rng)
    seg_t = torch.as_tensor(seg, device=cuda)
    got = segment_logw_cuda(u, pc, a, b, seg_t, n_seg)
    want = segment_logw_ref(u, pc, a, b, seg_t.long(), n_seg)
    mag = segment_logw_ref(torch.zeros_like(u), torch.ones_like(pc), a.abs(), b.abs(),
                           seg_t.long(), n_seg)
    _assert_sums_close(got, want, mag)
    assert torch.equal(got, segment_logw_cuda(u, pc, a, b, seg_t, n_seg))  # deterministic


def test_new_ops_count_kernel_launches(cuda):
    gen = torch.Generator(device=cuda).manual_seed(3)
    q, p = (torch.rand(4, 300, generator=gen, device=cuda) for _ in range(2))
    u = torch.rand(16, 300, generator=gen, device=cuda)
    seg = torch.zeros(300, dtype=torch.int32, device=cuda)
    for fn, args in [(ops.bernoulli_kl, (q, p)), (ops.bernoulli_kl_total, (q, p)),
                     (ops.bernoulli_kl_profile, (q, p)),
                     (ops.segment_logw, (u, p, q, p, seg, 1))]:
        before = fn.launches
        fn(*args)
        assert fn.launches == before + 1
    assert ops.segment_logw_fn() is ops.segment_logw


def test_new_kernel_wrappers_refuse_bad_input(cuda):
    q = torch.rand(4, 16, device=cuda)
    u = torch.rand(8, 16, device=cuda)
    seg = torch.zeros(16, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        kl.profile_cuda(q.double(), q.double())
    with pytest.raises(ValueError):
        kl.rows_cuda(q, q[:, :8])                        # shape mismatch
    with pytest.raises(ValueError):
        kl.total_cuda(q, q.cpu())                        # wrong device
    with pytest.raises(TypeError):
        segment_logw_cuda(u, q, q, q, seg.long(), 1)     # ids must be int32
    with pytest.raises(ValueError):
        segment_logw_cuda(u.t(), q, q, q, seg, 1)        # u of the wrong shape
    with pytest.raises(ValueError):
        segment_logw_cuda(u.expand(4, 8, 16), q, q, q, seg, 1)   # u per client
    with pytest.raises(ValueError):
        segment_logw_cuda(u[:, ::2], q[:, :8], q[:, :8], q[:, :8], seg[:8], 1)


def test_segment_encode_on_card_matches_cpu_route(cuda):
    """Full-width cohort segment encode: kernel on the card vs plain on the CPU."""
    g = torch.Generator().manual_seed(8)
    q = 0.05 + 0.9 * torch.rand(10, 28160, generator=g)
    p = torch.clamp(q + 0.05 * torch.randn(10, 28160, generator=g), 0.05, 0.95)
    seg = np.repeat(np.arange(40), 704).astype(np.int32)
    key = prng.PRNGKey(11, device="cpu")
    sels = prng.split(prng.PRNGKey(12, device="cpu"), 10)
    cpu = mrc.encode_segments(key, sels, q, p, seg, n_is=64, n_seg=40)
    gpu = mrc.encode_segments(key.to(cuda), sels.to(cuda), q.to(cuda), p.to(cuda), seg,
                              n_is=64, n_seg=40)
    same = gpu.indices.cpu() == cpu.indices
    # transcendental functions round differently on the card: near-ties only
    assert same.to(torch.float32).mean() >= 0.99
    keep = same[:, torch.as_tensor(seg, dtype=torch.int64)]
    assert torch.equal(gpu.sample.cpu()[keep], cpu.sample[keep])
    dec = mrc.decode_segments(key.to(cuda), gpu.indices, p.to(cuda), seg, n_is=64)
    assert torch.equal(dec, gpu.sample)


# ---------------------------------------------------------------------------
# The fused segment encoder (keyed form) and the one-launch KL.
# ---------------------------------------------------------------------------


def _encode_inputs(cuda, clients, nis, d, kind, seed):
    """Keys, clipped priors and coefficients (C, D), int32 ids of one kind."""
    gen = torch.Generator(device=cuda).manual_seed(seed)
    q = 0.05 + 0.9 * torch.rand(clients, d, generator=gen, device=cuda)
    p = torch.clamp(q + 0.05 * torch.randn(clients, d, generator=gen, device=cuda), 0.05, 0.95)
    a, b = (t.contiguous() for t in log_ratio_coeffs(q, p))
    seg, n_seg = _segmentation(kind, d, np.random.default_rng(seed))
    key = prng.PRNGKey(seed, device=cuda)
    sels = prng.split(prng.PRNGKey(seed + 1, device=cuda), clients)
    return key, sels, clip01(p).contiguous(), a, b, torch.as_tensor(seg, device=cuda), n_seg


ENCODE_CASES = [(10, 64, 28160, "random"), (10, 64, 28160, "single"),
                (3, 64, 28160, "singletons"), (3, 33, 1001, "skipping"),
                (2, 70, 513, "random"), (1, 1, 7, "single"), (17, 40, 3000, "random")]


@pytest.mark.parametrize("clients,nis,d,kind", ENCODE_CASES)
def test_keyed_and_u_fed_kernels_give_identical_logw(cuda, clients, nis, d, kind):
    """The keyed kernel draws u in place; fed prng's draw of the same key,
    the u-fed kernel gives bit-identical logW, so the in-kernel threefry is
    prng's exactly."""
    key, sels, pc, a, b, seg, n_seg = _encode_inputs(cuda, clients, nis, d, kind, d + nis)
    _, _, logw = sl.segment_mrc_encode_cuda(key, sels, pc, a, b, seg, nis, n_seg)
    u = sl.segment_candidates(key, nis, d)
    fed = segment_logw_cuda(u, pc, a, b, seg, n_seg)
    torch.cuda.synchronize()
    assert torch.equal(logw, fed)


@pytest.mark.parametrize("clients,nis,d,kind", ENCODE_CASES)
def test_keyed_encode_matches_plain_on_the_card(cuda, clients, nis, d, kind):
    """Indices equal the plain route's except at near-ties of logW + gumbel
    (the segment sums run in another order), counted and bounded; the
    sample is exact wherever the indices agree; logW within the sums'
    tolerance."""
    key, sels, pc, a, b, seg, n_seg = _encode_inputs(cuda, clients, nis, d, kind, d + 7)
    idx, sample, logw = sl.segment_mrc_encode_cuda(key, sels, pc, a, b, seg, nis, n_seg)
    w_idx, w_sample, w_logw = sl.segment_mrc_encode_ref(key, sels, pc, a, b, seg.long(), nis,
                                                        n_seg)
    mag = segment_logw_ref(torch.zeros(nis, d, device=cuda), torch.ones_like(pc), a.abs(),
                           b.abs(), seg.long(), n_seg)
    _assert_sums_close(logw, w_logw, mag)
    gu = prng.uniform(sels, (nis, n_seg))
    score = torch.sort(w_logw - torch.log(-torch.log(torch.clamp(gu, 1e-12, 1 - 1e-12))),
                       dim=1).values
    gap = (score[:, -1] - score[:, -2]) if nis > 1 else torch.full_like(score[:, 0], 1e9)
    diff = idx != w_idx
    print(f"keyed encode {clients}x{nis}x{d} {kind}: {int(diff.sum())} near-tie index "
          f"mismatches of {diff.numel()}, largest gap among them "
          f"{float(gap[diff].max()) if diff.any() else 0.0:.3e}")
    assert bool((gap[diff] < 1e-4).all())
    keep = ~diff[:, seg.long()]
    assert torch.equal(sample[keep], w_sample[keep])
    assert idx.dtype == torch.int64 and sample.dtype == torch.float32


def test_select_pass_is_the_decoder(cuda):
    """Pass 3 alone equals u[rows, arange(d)] < pc for arbitrary indices."""
    key, _, pc, _, _, seg, n_seg = _encode_inputs(cuda, 4, 64, 28160, "random", 3)
    idx = torch.randint(0, 64, (4, n_seg), device=cuda)
    u = sl.segment_candidates(key, 64, 28160)
    want = (u[idx[:, seg.long()], torch.arange(28160, device=cuda)] < pc).float()
    before = ops.segment_select.launches
    got = ops.segment_select(key, idx, pc, seg)
    torch.cuda.synchronize()
    assert ops.segment_select.launches == before + 1
    assert torch.equal(got, want)
    assert torch.equal(got, sl.segment_select_ref(key, idx, pc, seg))


def test_fused_kernels_are_deterministic(cuda):
    key, sels, pc, a, b, seg, n_seg = _encode_inputs(cuda, 10, 64, 28160, "random", 4)
    first = sl.segment_mrc_encode_cuda(key, sels, pc, a, b, seg, 64, n_seg)
    second = sl.segment_mrc_encode_cuda(key, sels, pc, a, b, seg, 64, n_seg)
    assert all(torch.equal(x, y) for x, y in zip(first, second))
    u = sl.segment_candidates(key, 64, 28160)
    assert torch.equal(segment_logw_cuda(u, pc, a, b, seg, n_seg),
                       segment_logw_cuda(u, pc, a, b, seg, n_seg))
    gen = torch.Generator(device=cuda).manual_seed(2)
    q, p = (torch.rand(3, 300000, generator=gen, device=cuda) for _ in range(2))
    runs = [(kl.total_cuda(q, p), kl.rows_cuda(q, p)) for _ in range(3)]  # tickets reset
    assert all(torch.equal(r[0], runs[0][0]) and torch.equal(r[1], runs[0][1])
               for r in runs[1:])


def test_ops_segment_mrc_encode_counts_one_launch(cuda):
    key, sels, pc, a, b, seg, n_seg = _encode_inputs(cuda, 2, 8, 600, "random", 5)
    before, fed = ops.segment_mrc_encode.launches, ops.segment_logw.launches
    ops.segment_mrc_encode(key, sels, pc, a, b, seg, 8, n_seg)
    assert ops.segment_mrc_encode.launches == before + 1
    assert ops.segment_logw.launches == fed
    res = mrc.encode_segments(key, sels, pc, pc, seg.cpu().numpy(), n_is=8, n_seg=n_seg)
    assert ops.segment_mrc_encode.launches == before + 2 and ops.segment_logw.launches == fed
    assert tuple(res.indices.shape) == (2, n_seg)


def test_fused_wrappers_refuse_bad_input(cuda):
    key, sels, pc, a, b, seg, n_seg = _encode_inputs(cuda, 2, 8, 64, "random", 6)
    with pytest.raises(TypeError):
        sl.segment_mrc_encode_cuda(key.int(), sels, pc, a, b, seg, 8, n_seg)
    with pytest.raises(ValueError):                                     # key shape
        sl.segment_mrc_encode_cuda(prng.split(key, 3), sels, pc, a, b, seg, 8, n_seg)
    with pytest.raises(ValueError):
        sl.segment_mrc_encode_cuda(key, sels[:1], pc, a, b, seg, 8, n_seg)  # one key short
    with pytest.raises(TypeError):
        sl.segment_mrc_encode_cuda(key, sels, pc, a, b, seg.long(), 8, n_seg)
    with pytest.raises(ValueError):
        sl.segment_mrc_encode_cuda(key.cpu(), sels, pc, a, b, seg, 8, n_seg)
    with pytest.raises(ValueError):
        sl.segment_select_cuda(key, torch.zeros(2, n_seg, dtype=torch.int32, device=cuda),
                               pc, seg)


# ---------------------------------------------------------------------------
# The keyed encoder under per-client keys (the PR variants' private candidates).
# ---------------------------------------------------------------------------

CLIENT_KEY_CASES = [(10, 64, 28160, "random"), (1, 64, 28160, "random"),
                    (3, 33, 1001, "skipping"), (4, 16, 513, "single"),
                    (2, 8, 515, "singletons"), (17, 40, 3000, "random"), (1, 1, 7, "single")]


def _client_keys(key, clients):
    return mrc.client_key(key, torch.arange(clients, device=key.device))


@pytest.mark.parametrize("clients,nis,d,kind", CLIENT_KEY_CASES)
def test_client_keyed_and_u_fed_kernels_give_identical_logw(cuda, clients, nis, d, kind):
    """(C, 2) keys: client c's logW is bit-identical to the u-fed kernel fed
    prng's draw of key[c]; at D not a multiple of 4, one segment, a segment
    per parameter and C = 1 too."""
    key, sels, pc, a, b, seg, n_seg = _encode_inputs(cuda, clients, nis, d, kind, d + nis)
    keys = _client_keys(key, clients)
    _, _, logw = sl.segment_mrc_encode_cuda(keys, sels, pc, a, b, seg, nis, n_seg)
    fed = torch.stack([segment_logw_cuda(sl.segment_candidates(keys[c], nis, d), pc[c],
                                         a[c], b[c], seg, n_seg) for c in range(clients)])
    torch.cuda.synchronize()
    assert torch.equal(logw, fed)


@pytest.mark.parametrize("clients,nis,d,kind", CLIENT_KEY_CASES)
def test_client_keyed_encode_matches_plain_on_the_card(cuda, clients, nis, d, kind):
    """Indices equal the plain route's but at near-ties (counted, each below
    1e-4), the sample exact where they agree, and the select pass under the
    same (C, 2) keys returns the sample."""
    key, sels, pc, a, b, seg, n_seg = _encode_inputs(cuda, clients, nis, d, kind, d + 9)
    keys = _client_keys(key, clients)
    idx, sample, logw = sl.segment_mrc_encode_cuda(keys, sels, pc, a, b, seg, nis, n_seg)
    w_idx, w_sample, w_logw = sl.segment_mrc_encode_ref(keys, sels, pc, a, b, seg.long(), nis,
                                                        n_seg)
    mag = segment_logw_ref(torch.zeros(nis, d, device=cuda), torch.ones_like(pc), a.abs(),
                           b.abs(), seg.long(), n_seg)
    _assert_sums_close(logw, w_logw, mag)
    gu = prng.uniform(sels, (nis, n_seg))
    score = torch.sort(w_logw - torch.log(-torch.log(torch.clamp(gu, 1e-12, 1 - 1e-12))),
                       dim=1).values
    gap = (score[:, -1] - score[:, -2]) if nis > 1 else torch.full_like(score[:, 0], 1e9)
    diff = idx != w_idx
    print(f"client-keyed encode {clients}x{nis}x{d} {kind}: {int(diff.sum())} near-tie "
          f"index mismatches of {diff.numel()}")
    assert bool((gap[diff] < 1e-4).all())
    keep = ~diff[:, seg.long()]
    assert torch.equal(sample[keep], w_sample[keep])
    assert torch.equal(sl.segment_select_cuda(keys, idx, pc, seg), sample)
    assert torch.equal(sl.segment_select_ref(keys, idx, pc, seg.long()), sample)


def test_shared_key_results_do_not_change_with_the_stride(cuda):
    """The shared key (stride 0) and the same key repeated per client
    (stride 2) give bit-identical logW, indices and samples."""
    key, sels, pc, a, b, seg, n_seg = _encode_inputs(cuda, 10, 64, 28160, "random", 11)
    shared = sl.segment_mrc_encode_cuda(key, sels, pc, a, b, seg, 64, n_seg)
    repeated = sl.segment_mrc_encode_cuda(key.expand(10, 2).contiguous(), sels, pc, a, b, seg,
                                          64, n_seg)
    assert all(torch.equal(x, y) for x, y in zip(shared, repeated))
    other = sl.segment_mrc_encode_cuda(_client_keys(key, 10), sels, pc, a, b, seg, 64, n_seg)
    assert not torch.equal(other[2], shared[2])


def test_client_keyed_wrappers_refuse_wrong_key_shapes(cuda):
    key, sels, pc, a, b, seg, n_seg = _encode_inputs(cuda, 3, 8, 64, "random", 12)
    keys = _client_keys(key, 3)
    idx = torch.zeros(3, n_seg, dtype=torch.int64, device=cuda)
    for bad in (keys[:2], keys[None], keys[:, :1].contiguous(), keys.t().contiguous()[:, :2],
                keys.int(), keys.cpu()):
        with pytest.raises((ValueError, TypeError)):
            sl.segment_mrc_encode_cuda(bad, sels, pc, a, b, seg, 8, n_seg)
        with pytest.raises((ValueError, TypeError)):
            sl.segment_select_cuda(bad, idx, pc, seg)
    with pytest.raises(ValueError):                     # not contiguous
        sl.segment_select_cuda(torch.stack([keys[:, 0], keys[:, 1]], 1).t().contiguous().t(),
                               idx, pc, seg)
    assert sl.segment_select_cuda(keys, idx, pc, seg).shape == pc.shape


def test_ops_client_keyed_encode_counts_one_launch(cuda):
    key, sels, pc, a, b, seg, n_seg = _encode_inputs(cuda, 4, 16, 600, "random", 13)
    keys = _client_keys(key, 4)
    before = ops.segment_mrc_encode.launches
    res = mrc.encode_segments(keys, sels, pc, pc, seg.cpu().numpy(), n_is=16, n_seg=n_seg)
    assert ops.segment_mrc_encode.launches == before + 1
    before = ops.segment_select.launches
    dec = mrc.decode_segments(keys, res.indices, pc, seg.cpu().numpy(), n_is=16)
    assert ops.segment_select.launches == before + 1
    assert torch.equal(dec, res.sample)


# ---------------------------------------------------------------------------
# The fused fixed-block encoder (ops.mrc_fixed_encode), keyed form of mrc_logw.
# ---------------------------------------------------------------------------

from repro_torch.kernels import mrc_weights as mw  # noqa: E402

# (clients, B, S, n_is): GR's and PR's encode, CFL's, GR-Reconst's broadcast,
# and ragged shapes (S not a multiple of 4, S above 128, S = 1, more clients
# than the kernel stages at once, odd n_is).
FIXED_CASES = [(10, 220, 128, 64), (10, 1760, 16, 256), (1, 220, 128, 64), (3, 7, 7, 33),
               (2, 5, 100, 48), (4, 3, 513, 20), (17, 9, 16, 40), (2, 11, 1, 5)]
# Near-ties: a kernel index may differ from the plain route's only where
# the plain route's top-2 gap of logW + gumbel is below this.
FIXED_NEAR_TIE = 1e-4


def _fixed_inputs(cuda, clients, n_blocks, s, key_kind, seed):
    """Keys (shared (2,) or one per client), selection keys (C, 2), clipped
    priors and coefficients (C, B, S)."""
    gen = torch.Generator(device=cuda).manual_seed(seed)
    q = 0.05 + 0.9 * torch.rand(clients, n_blocks, s, generator=gen, device=cuda)
    p = torch.clamp(q + 0.05 * torch.randn(clients, n_blocks, s, generator=gen, device=cuda),
                    0.05, 0.95)
    a, b = (t.contiguous() for t in log_ratio_coeffs(q, p))
    key = prng.PRNGKey(seed, device=cuda)
    if key_kind == "client":
        key = mrc.client_key(key, torch.arange(clients, device=cuda))
    sels = prng.split(prng.PRNGKey(seed + 1, device=cuda), clients)
    return key, sels, clip01(p).contiguous(), a, b


def _u_fed_fixed_logw(key, pc, a, b, nis):
    """The u-fed kernel fed prng's candidates of ``key``: (C, B, n_is)."""
    clients, n_blocks, s = pc.shape
    u = mw.block_candidates(key, n_blocks, nis, s)
    x = (u < pc[..., None, :]).to(torch.float32)
    return mw.mrc_logw_cuda(x.reshape(-1, nis, s), a.reshape(-1, s),
                            b.reshape(-1, s)).reshape(clients, n_blocks, nis)


@pytest.mark.parametrize("key_kind", ["shared", "client"])
@pytest.mark.parametrize("clients,n_blocks,s,nis", FIXED_CASES)
def test_fixed_keyed_and_u_fed_kernels_give_identical_logw(cuda, clients, n_blocks, s, nis,
                                                            key_kind):
    """The keyed form draws the candidates in place; the u-fed form fed
    prng's draw of the same key(s) gives bit-identical logW: the in-kernel
    threefry is prng's exactly and both forms sum a row in one order."""
    key, sels, pc, a, b = _fixed_inputs(cuda, clients, n_blocks, s, key_kind, s + nis)
    _, _, logw = mw.mrc_fixed_encode_cuda(key, sels, pc, a, b, nis)
    fed = _u_fed_fixed_logw(key, pc, a, b, nis)
    torch.cuda.synchronize()
    assert torch.equal(logw, fed)


@pytest.mark.parametrize("key_kind", ["shared", "client"])
@pytest.mark.parametrize("clients,n_blocks,s,nis", FIXED_CASES)
def test_fixed_keyed_encode_matches_plain_on_the_card(cuda, clients, n_blocks, s, nis,
                                                      key_kind):
    """Indices equal the plain route's but at near-ties of logW + gumbel
    (counted, each below FIXED_NEAR_TIE), the sample exact wherever they
    agree, logW within the sums' tolerance, and the decoder's
    regeneration of the chosen rows equal to the sample."""
    key, sels, pc, a, b = _fixed_inputs(cuda, clients, n_blocks, s, key_kind, s + nis + 3)
    idx, sample, logw = mw.mrc_fixed_encode_cuda(key, sels, pc, a, b, nis)
    w_idx, w_sample, w_logw = mw.mrc_fixed_encode_ref(key, sels, pc, a, b, nis)
    mag = (a.abs().sum(-1) + b.abs().sum(-1))[..., None].expand_as(w_logw)
    _assert_sums_close(logw, w_logw, mag)
    score = torch.sort(w_logw + mw.block_gumbel(sels, n_blocks, nis), dim=-1).values
    gap = (score[..., -1] - score[..., -2]) if nis > 1 else torch.full_like(score[..., 0], 1e9)
    diff = idx != w_idx
    print(f"fixed encode {key_kind} ({clients}, {n_blocks}, {s}, {nis}): {int(diff.sum())} "
          f"near-tie index mismatches of {diff.numel()}")
    assert bool((gap[diff] < FIXED_NEAR_TIE).all())
    assert torch.equal(sample[~diff], w_sample[~diff])
    assert idx.dtype == torch.int64 and sample.dtype == torch.float32
    assert bool(((idx >= 0) & (idx < nis)).all())
    assert torch.equal(mrc.decode_fixed(key, idx, pc, n_is=nis), sample)


def test_fixed_encode_is_deterministic_and_shares_one_draw(cuda):
    """Two calls give the same bits; a shared key repeated per client gives
    the shared form's results; a (B, S) target with a (2,) selection key
    is the one-client batch."""
    key, sels, pc, a, b = _fixed_inputs(cuda, 10, 1760, 16, "shared", 31)
    first = mw.mrc_fixed_encode_cuda(key, sels, pc, a, b, 256)
    second = mw.mrc_fixed_encode_cuda(key, sels, pc, a, b, 256)
    assert all(torch.equal(x, y) for x, y in zip(first, second))
    repeated = mw.mrc_fixed_encode_cuda(key.expand(10, 2).contiguous(), sels, pc, a, b, 256)
    assert all(torch.equal(x, y) for x, y in zip(first, repeated))
    one = mw.mrc_fixed_encode_cuda(key, sels[3], pc[3], a[3], b[3], 256)
    assert all(torch.equal(x, y[3]) for x, y in zip(one, first))
    x = (mw.block_candidates(key, 1760, 256, 16) < pc[..., None, :]).float()
    fed = mw.mrc_logw_cuda(x.reshape(-1, 256, 16), a.reshape(-1, 16), b.reshape(-1, 16))
    assert torch.equal(fed, mw.mrc_logw_cuda(x.reshape(-1, 256, 16), a.reshape(-1, 16),
                                             b.reshape(-1, 16)))


def test_ops_mrc_fixed_encode_counts_one_launch(cuda):
    key, sels, pc, a, b = _fixed_inputs(cuda, 4, 30, 16, "client", 32)
    before, fed = ops.mrc_fixed_encode.launches, ops.mrc_logw.launches
    ops.mrc_fixed_encode(key, sels, pc, a, b, 32)
    assert ops.mrc_fixed_encode.launches == before + 1 and ops.mrc_logw.launches == fed
    res = mrc.encode_fixed(key, sels, pc, pc, n_is=32)
    assert ops.mrc_fixed_encode.launches == before + 2 and ops.mrc_logw.launches == fed
    hooked = mrc.encode_fixed(key, sels, pc, pc, n_is=32, logw_fn=ops.mrc_logw_fn())
    assert ops.mrc_fixed_encode.launches == before + 2 and ops.mrc_logw.launches == fed + 1
    assert tuple(res.indices.shape) == (4, 30) and tuple(hooked.indices.shape) == (4, 30)


def test_fixed_encode_wrapper_refuses_bad_input(cuda):
    key, sels, pc, a, b = _fixed_inputs(cuda, 3, 8, 16, "shared", 33)
    keys = mrc.client_key(key, torch.arange(3, device=cuda))
    for bad_key in (key.int(), prng.split(key, 2), keys[None], keys.cpu(), keys[:, :1]):
        with pytest.raises((ValueError, TypeError)):
            mw.mrc_fixed_encode_cuda(bad_key, sels, pc, a, b, 8)
    for bad_sel in (sels[:2], sels[0], sels.cpu(), sels.int()):
        with pytest.raises((ValueError, TypeError)):
            mw.mrc_fixed_encode_cuda(key, bad_sel, pc, a, b, 8)
    with pytest.raises(TypeError):
        mw.mrc_fixed_encode_cuda(key, sels, pc.double(), a, b, 8)
    with pytest.raises(ValueError):
        mw.mrc_fixed_encode_cuda(key, sels, pc.transpose(1, 2).contiguous().transpose(1, 2),
                                 a, b, 8)                                # not contiguous
    with pytest.raises(ValueError):
        mw.mrc_fixed_encode_cuda(key, sels, pc, a[:, :4].contiguous(), b, 8)
    for nis in (0, -1):
        with pytest.raises(ValueError):
            mw.mrc_fixed_encode_cuda(key, sels, pc, a, b, nis)
    wide = torch.full((1, 1, 40000), 0.5, device=cuda)                   # S beyond the stage
    with pytest.raises(ValueError, match="out of range"):
        mw.mrc_fixed_encode_cuda(key, sels[:1], wide, wide, wide, 8)


# ---------------------------------------------------------------------------
# The model substrate's kernels: flash attention and the chunked RWKV-6 mix.
# ---------------------------------------------------------------------------

from repro_torch.kernels import flash_attn as fa  # noqa: E402
from repro_torch.kernels import rwkv_chunk as rc  # noqa: E402

# f32 inputs: the kernel sums the same f32 terms as its plain version in
# another order (the f32 flash kernel's split-TF32 products within 2^-22 of
# each), so it is held within 1e-5 x the magnitude of those terms
# (softmax-weighted |v| for attention, |o|'s largest entry for RWKV).
F32_RTOL = 1e-5
# bf16 outputs: both round an f32 result to bf16 (8 bits of mantissa), so
# one bf16 ulp of the output's magnitude, plus the f32 noise above.
BF16_ULPS = 1


def _bf16_ulp(x):
    return torch.finfo(torch.bfloat16).eps * x.abs().to(torch.float32)


def _flash_inputs(b, sq, skv, h, hkv, dh, dtype, device, seed):
    gen = torch.Generator(device=device).manual_seed(seed)
    q = torch.randn(b, sq, h, dh, generator=gen, device=device).to(dtype)
    k = torch.randn(b, skv, hkv, dh, generator=gen, device=device).to(dtype)
    v = torch.randn(b, skv, hkv, dh, generator=gen, device=device).to(dtype)
    return q, k, v


def _assert_attn_close(got, q, k, v, **kw):
    want = fa.flash_attention_ref(q, k, v, **kw)
    # magnitude of the terms: the same attention over |v|
    mag = fa.flash_attention_ref(q.float(), k.float(), v.float().abs(), **kw)
    tol = F32_RTOL * mag + 1e-6
    if got.dtype == torch.bfloat16:
        tol = tol + BF16_ULPS * _bf16_ulp(want)
    err = (got.float() - want.float()).abs()
    assert got.shape == want.shape and got.dtype == want.dtype
    assert bool(torch.isfinite(got).all())
    assert bool((err <= tol).all()), float((err / tol).max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,causal,window", [
    ((1, 128, 128, 2, 2, 128), True, 0), ((2, 64, 96, 4, 2, 32), False, 0),
    ((1, 130, 257, 2, 1, 64), True, 0), ((2, 32, 512, 8, 8, 128), False, 0),
    ((1, 1000, 1000, 4, 2, 64), True, 256), ((2, 77, 77, 6, 3, 40), True, 16),
    ((1, 1, 1, 1, 1, 8), True, 0)])
def test_flash_attention_kernel_matches_plain(cuda, shape, causal, window, dtype):
    q, k, v = _flash_inputs(*shape, dtype=dtype, device=cuda, seed=sum(shape))
    kw = dict(causal=causal, window=window, scale=shape[-1] ** -0.5)
    got = fa.flash_attention_cuda(q, k, v, **kw)
    torch.cuda.synchronize()
    _assert_attn_close(got, q, k, v, **kw)


def test_flash_attention_kernel_reads_strided_views(cuda):
    """q, k, v sliced out of one fused (B, S, H + 2 Hkv, Dh) projection."""
    qkv = torch.randn(2, 100, 8, 64, device=cuda)
    q, k, v = qkv[:, :, :4], qkv[:, :, 4:6], qkv[:, :, 6:]
    assert not q.is_contiguous()
    got = fa.flash_attention_cuda(q, k, v, causal=True, scale=0.125)
    torch.cuda.synchronize()
    _assert_attn_close(got, q.contiguous(), k.contiguous(), v.contiguous(), causal=True,
                       scale=0.125)


@pytest.mark.parametrize("shape,causal,window", [
    ((1, 200, 200, 2, 1, 8), True, 0), ((2, 200, 200, 4, 2, 40), True, 0),
    ((2, 150, 150, 4, 2, 64), True, 0), ((1, 330, 330, 4, 2, 128), True, 0),
    ((1, 100, 300, 4, 2, 64), True, 0), ((1, 300, 100, 2, 2, 128), True, 0),
    ((2, 90, 250, 4, 1, 40), False, 0), ((1, 1000, 1000, 2, 1, 128), True, 256),
    ((1, 700, 700, 2, 2, 64), False, 256)])
def test_flash_attention_bf16_kernel_ragged_shapes(cuda, shape, causal, window):
    """The wgmma kernel at every Dh class (8, 40, 64, 128), Sq not a
    multiple of its 128-row block, Sq != Skv, windows across tile edges."""
    q, k, v = _flash_inputs(*shape, dtype=torch.bfloat16, device=cuda, seed=sum(shape) + 1)
    kw = dict(causal=causal, window=window, scale=shape[-1] ** -0.5)
    got = fa.flash_attention_cuda(q, k, v, **kw)
    torch.cuda.synchronize()
    _assert_attn_close(got, q, k, v, **kw)


def test_flash_attention_bf16_kernel_reads_fused_qkv_view(cuda):
    """bf16 q, k, v sliced out of one fused (B, S, H + 2 Hkv, Dh) projection:
    the tensor maps take the view's strides, no copy."""
    qkv = torch.randn(2, 300, 16, 128, device=cuda).to(torch.bfloat16)
    q, k, v = qkv[:, :, :8], qkv[:, :, 8:12], qkv[:, :, 12:]
    assert not q.is_contiguous()
    got = fa.flash_attention_cuda(q, k, v, causal=True, scale=128 ** -0.5)
    torch.cuda.synchronize()
    _assert_attn_close(got, q.contiguous(), k.contiguous(), v.contiguous(), causal=True,
                       scale=128 ** -0.5)


def test_flash_attention_bf16_kernel_refuses_what_tma_cannot_load(cuda):
    flat = torch.randn(1 + 64 * 4 * 32, device=cuda).to(torch.bfloat16)
    q = flat[1:].view(1, 64, 4, 32)                     # storage offset of 1 element
    k = v = torch.randn(1, 64, 4, 32, device=cuda).to(torch.bfloat16)
    with pytest.raises(ValueError, match="aligned"):
        fa.flash_attention_cuda(q, k, v)
    wide = torch.randn(1, 64, 4, 36, device=cuda).to(torch.bfloat16)
    with pytest.raises(ValueError, match="multiples of 16"):
        fa.flash_attention_cuda(wide[..., :32], k, v)   # head stride of 72 bytes
    before = ops.flash_attention.launches
    with pytest.raises(ValueError):
        ops.flash_attention(q, k, v)
    assert ops.flash_attention.launches == before


@pytest.mark.parametrize("shape,causal,window", [
    ((1, 200, 200, 2, 1, 8), True, 0),        # Dh 8: one k8 step, one 32-column panel
    ((2, 200, 200, 4, 2, 40), True, 0),       # Dh 40: a panel and 8 columns of a second
    ((2, 200, 200, 4, 2, 80), True, 0),       # Dh 80 (HuBERT's): PV over 96 columns
    ((1, 330, 330, 16, 8, 128), True, 0),     # Dh 128, rep 2, last q block of 10 rows
    ((1, 100, 300, 4, 2, 64), True, 0),       # Sq < Skv
    ((1, 300, 100, 2, 2, 128), True, 0),      # Sq > Skv, rep 1
    ((2, 90, 250, 8, 1, 40), False, 0),       # rep 8, Skv off the 32-key tiles
    ((1, 1000, 1000, 2, 1, 128), True, 256),  # a window across tile edges
    ((1, 700, 700, 2, 2, 64), False, 100),    # a window off the tiles, non-causal
    ((1, 65, 65, 1, 1, 128), True, 0)])       # a last q block of one row
def test_flash_attention_f32_kernel_edge_shapes(cuda, shape, causal, window):
    """The split-TF32 kernel at its edges: every panel count (Dh 8, 40, 80,
    128), Sq != Skv, GQA groups of 1, 2 and 8, ragged q blocks and key
    tiles, windows across tile edges."""
    q, k, v = _flash_inputs(*shape, dtype=torch.float32, device=cuda, seed=sum(shape) + 3)
    kw = dict(causal=causal, window=window, scale=shape[-1] ** -0.5)
    got = fa.flash_attention_cuda(q, k, v, **kw)
    torch.cuda.synchronize()
    _assert_attn_close(got, q, k, v, **kw)


def test_flash_attention_f32_kernel_reads_heads_first_views(cuda):
    """f32 q, k, v as (B, H, S, Dh) tensors viewed as (B, S, H, Dh): every
    stride but the last differs from the packed layout."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    q, k, v = (torch.randn(2, n, 150, 64, generator=gen, device=cuda).transpose(1, 2)
               for n in (8, 2, 2))
    assert not q.is_contiguous()
    got = fa.flash_attention_cuda(q, k, v, causal=True, scale=0.125)
    torch.cuda.synchronize()
    _assert_attn_close(got, q.contiguous(), k.contiguous(), v.contiguous(), causal=True,
                       scale=0.125)


def _attn_exact(q, k, v, *, causal, scale):
    """The attention in float64, one softmax over every key."""
    rep = q.shape[2] // k.shape[2]
    kd, vd = (t.double().repeat_interleave(rep, dim=2) for t in (k, v))
    s = torch.einsum("bqhd,bkhd->bhqk", q.double(), kd) * scale
    i = torch.arange(q.shape[1], device=q.device)[:, None]
    j = torch.arange(k.shape[1], device=q.device)[None, :]
    if causal:
        s = s.masked_fill(j > i, -torch.inf)
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), vd), float(s.abs().max())


def test_flash_attention_f32_kernel_large_scores(cuda):
    """Scores of magnitude ~30, a sharp softmax.  With Dh 8 the kernel is
    held to the plain version at the bound.  With Dh 128 each score sums 128
    products of size ~6 in f32, and the plain version's own error against
    float64 reaches 0.68-1.0 of the bound (two f32 summation orders can
    differ by more than it), so there the kernel is held to float64 at the
    bound: no further from the exact value than f32 arithmetic is."""
    q, k, v = _flash_inputs(2, 200, 200, 2, 1, 8, dtype=torch.float32, device=cuda, seed=11)
    q = q * 5.0
    kw = dict(causal=True, window=0, scale=8 ** -0.5)
    assert _attn_exact(q, k, v, causal=True, scale=kw["scale"])[1] > 25.0
    got = fa.flash_attention_cuda(q, k, v, **kw)
    torch.cuda.synchronize()
    _assert_attn_close(got, q, k, v, **kw)
    q, k, v = _flash_inputs(2, 200, 200, 2, 1, 128, dtype=torch.float32, device=cuda, seed=12)
    q = q * 6.0
    kw = dict(causal=True, window=0, scale=128 ** -0.5)
    exact, smax = _attn_exact(q, k, v, causal=True, scale=kw["scale"])
    assert smax > 25.0
    got = fa.flash_attention_cuda(q, k, v, **kw)
    torch.cuda.synchronize()
    tol = F32_RTOL * fa.flash_attention_ref(q, k, v.abs(), **kw) + 1e-6
    assert bool(torch.isfinite(got).all())
    assert bool(((got.double() - exact).abs() <= tol).all()), \
        float(((got.double() - exact).abs() / tol).max())


def test_flash_attention_f32_kernel_refuses_misaligned_views(cuda):
    """The f32 kernel's 16-byte loads take the bf16 kernel's rules."""
    flat = torch.randn(1 + 64 * 4 * 32, device=cuda)
    q = flat[1:].view(1, 64, 4, 32)                     # storage offset of 4 bytes
    k = v = torch.randn(1, 64, 4, 32, device=cuda)
    with pytest.raises(ValueError, match="aligned"):
        fa.flash_attention_cuda(q, k, v)
    wide = torch.randn(1, 64, 4, 34, device=cuda)
    with pytest.raises(ValueError, match="multiples of 16"):
        fa.flash_attention_cuda(wide[..., :32], k, v)   # head stride of 136 bytes
    before = ops.flash_attention.launches
    with pytest.raises(ValueError):
        ops.flash_attention(q, k, v)
    assert ops.flash_attention.launches == before


def _rwkv_inputs(b, s, h, dtype, device, seed, strong=False):
    gen = torch.Generator(device=device).manual_seed(seed)
    r, k, v = (torch.randn(b, s, h, 64, generator=gen, device=device) for _ in range(3))
    logw = -torch.exp(torch.randn(b, s, h, 64, generator=gen, device=device) - 2.0)
    if strong:
        logw = torch.full_like(logw, -15.0)
    u = 0.1 * torch.randn(h, 64, generator=gen, device=device)
    return (*(t.to(dtype) for t in (r, k, v, logw)), u)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,strong", [(2, 128, 2, False), (2, 100, 2, False),
                                          (1, 64, 3, True), (3, 1, 2, False),
                                          (2, 300, 4, True), (1, 1000, 2, False)])
def test_rwkv_kernel_matches_plain(cuda, b, s, h, strong, dtype):
    r, k, v, logw, u = _rwkv_inputs(b, s, h, dtype, cuda, seed=s + h, strong=strong)
    got = rc.rwkv_time_mix_cuda(r, k, v, logw, u)
    torch.cuda.synchronize()
    want = rc.rwkv_time_mix_ref(r, k, v, logw, u)
    assert got.shape == want.shape and got.dtype == dtype
    assert bool(torch.isfinite(got).all())
    tol = F32_RTOL * want.float().abs().max() + 1e-6
    if dtype == torch.bfloat16:
        tol = tol + BF16_ULPS * _bf16_ulp(want)
    err = (got.float() - want.float()).abs()
    assert bool((err <= tol).all()), float((err / tol).max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h", [(1, 2085, 64), (3, 1500, 48), (2, 4133, 8)])
def test_rwkv_kernel_many_chunks(cuda, b, s, h, dtype):
    """Many chunks and a ragged tail, with B * H below (64, 16) and above
    (144) the card's 132 SMs: pass B's grid is (B * H, 4)."""
    r, k, v, logw, u = _rwkv_inputs(b, s, h, dtype, cuda, seed=b + s + h)
    got = rc.rwkv_time_mix_cuda(r, k, v, logw, u)
    torch.cuda.synchronize()
    want = rc.rwkv_time_mix_ref(r, k, v, logw, u)
    assert got.shape == want.shape and got.dtype == dtype
    assert bool(torch.isfinite(got).all())
    tol = F32_RTOL * want.float().abs().max() + 1e-6
    if dtype == torch.bfloat16:
        tol = tol + BF16_ULPS * _bf16_ulp(want)
    err = (got.float() - want.float()).abs()
    assert bool((err <= tol).all()), float((err / tol).max())


def test_model_kernel_ops_count_launches(cuda):
    q, k, v = _flash_inputs(1, 64, 64, 4, 2, 32, torch.bfloat16, cuda, 1)
    r, kk, vv, logw, u = _rwkv_inputs(1, 70, 2, torch.float32, cuda, 2)
    for fn, args, kw in [(ops.flash_attention, (q, k, v), dict(causal=True, scale=0.2)),
                         (ops.rwkv_time_mix, (r, kk, vv, logw, u), {})]:
        before = fn.launches
        fn(*args, **kw)
        fn(*args, **kw)
        assert fn.launches == before + 2


def test_model_kernel_wrappers_refuse_bad_input(cuda):
    q, k, v = _flash_inputs(1, 16, 16, 4, 2, 32, torch.float32, cuda, 3)
    with pytest.raises(TypeError):
        fa.flash_attention_cuda(q.double(), k.double(), v.double())     # dtype
    with pytest.raises(TypeError):
        fa.flash_attention_cuda(q, k.bfloat16(), v)                     # mixed dtypes
    with pytest.raises(ValueError):
        fa.flash_attention_cuda(*(t[..., :12] for t in (q, k, v)))      # Dh 12
    with pytest.raises(ValueError):
        fa.flash_attention_cuda(*(torch.randn(1, 16, 4, 136, device=cuda)
                                  for _ in range(3)))                   # Dh 136
    with pytest.raises(ValueError):
        fa.flash_attention_cuda(q[:, :, :3], k, v)                      # H % Hkv
    with pytest.raises(ValueError):
        fa.flash_attention_cuda(q, k.cpu(), v)                          # device
    with pytest.raises(ValueError):
        fa.flash_attention_cuda(q[..., ::2], k[..., ::2], v[..., ::2])  # last stride
    with pytest.raises(RuntimeError, match="grad"):
        fa.flash_attention_cuda(q.requires_grad_(), k, v)
    r, kk, vv, logw, u = _rwkv_inputs(1, 70, 2, torch.float32, cuda, 4)
    with pytest.raises(TypeError):
        rc.rwkv_time_mix_cuda(r.double(), kk.double(), vv.double(), logw.double(), u)
    with pytest.raises(TypeError):
        rc.rwkv_time_mix_cuda(r, kk, vv, logw, u.double())
    with pytest.raises(ValueError):
        rc.rwkv_time_mix_cuda(*(t[..., :32] for t in (r, kk, vv, logw)), u[:, :32])
    with pytest.raises(ValueError):
        rc.rwkv_time_mix_cuda(r, kk, vv, logw, u[:1])                   # u shape
    with pytest.raises(ValueError):
        rc.rwkv_time_mix_cuda(r, kk.cpu(), vv, logw, u)
    with pytest.raises(RuntimeError, match="grad"):
        rc.rwkv_time_mix_cuda(r.requires_grad_(), kk, vv, logw, u)
    with pytest.raises(ValueError, match="cpu, meta or cuda"):
        ops._route(ops.rwkv_time_mix, None, None, types.SimpleNamespace(device=torch.device("xpu")))


# ---------------------------------------------------------------------------
# The fused path: bucketed plans and captured rounds.
# ---------------------------------------------------------------------------

from repro_torch import quickstart  # noqa: E402
from repro_torch.core import blocks  # noqa: E402
from repro_torch.fl.data import Dataset  # noqa: E402
from repro_torch.fl.engine import FLEngine  # noqa: E402
from repro_torch.fl.registry import bicompfl_spec  # noqa: E402


def _profile(device, d, seed, head=False):
    """A rough KL profile; ``head``: a spike at parameter 0, so that the
    first bin edges collapse there (an empty segment 0, ids from 1)."""
    gen = torch.Generator().manual_seed(seed)
    klp = 0.02 * torch.rand(d, generator=gen) ** 4
    klp[torch.randint(0, d, (3,), generator=gen)] += 2.0
    if head:
        klp[0] = 40.0
    return klp.to(device)


@pytest.mark.parametrize("keys", ["shared", "client"])
@pytest.mark.parametrize("clients,nis,d,nb", [(10, 64, 28160, 256), (3, 33, 1001, 40)])
def test_keyed_encode_takes_a_bucketed_plan(cuda, clients, nis, d, nb, keys):
    """``finalize_plan``'s device ids, with an empty segment 0 and empty
    trailing segments up to the template's capacity: the keyed encoder
    against its plain version (empty segments weigh exactly 0), under a
    shared key (GR) and under (C, 2) client keys (PR's private candidates)."""
    plan = blocks.AdaptiveAllocation(n_is=nis).finalize_plan(
        blocks.BlockPlan(size=None, n_blocks=nb, seg_ids=None, overhead_bits=0.0),
        {"profile": _profile(cuda, d, nb, head=True)}, d)
    seg, billable = plan.seg_ids, int(plan.billable_blocks)
    assert int(seg[0]) == 1 and billable < nb and seg.dtype == torch.int32
    key, sels, pc, a, b, _, _ = _encode_inputs(cuda, clients, nis, d, "random", d + 9)
    if keys == "client":
        key = _client_keys(key, clients)
    idx, sample, logw = sl.segment_mrc_encode_cuda(key, sels, pc, a, b, seg, nis, nb)
    w_idx, w_sample, w_logw = sl.segment_mrc_encode_ref(key, sels, pc, a, b, seg.long(), nis,
                                                        nb)
    empty = torch.ones(nb, dtype=torch.bool, device=cuda)
    empty[seg.long()] = False
    assert bool(empty[0]) and bool((logw[:, :, empty] == 0).all())
    mag = segment_logw_ref(torch.zeros(nis, d, device=cuda), torch.ones_like(pc), a.abs(),
                           b.abs(), seg.long(), nb)
    _assert_sums_close(logw, w_logw, mag)
    gu = prng.uniform(sels, (nis, nb))
    score = torch.sort(w_logw - torch.log(-torch.log(torch.clamp(gu, 1e-12, 1 - 1e-12))),
                       dim=1).values
    gap = score[:, -1] - score[:, -2]
    diff = idx != w_idx
    assert bool((gap[diff] < 1e-4).all())
    keep = ~diff[:, seg.long()]
    assert torch.equal(sample[keep], w_sample[keep])
    assert torch.equal(sl.segment_select_cuda(key, idx, pc, seg), sample)


def test_bucket_api_on_the_card_equals_the_cpu(cuda):
    """The same float adds in the same order: on the same profile and total,
    bucket index, segment ids, billable count and the cumulative sum equal
    on the card and the CPU."""
    for seed, head in ((1, False), (2, True), (3, False)):
        klp = _profile("cpu", 28160, seed, head)
        cum = blocks.scan_cumsum(klp)
        assert torch.equal(blocks.scan_cumsum(klp.to(cuda)).cpu(), cum)
        q = torch.linspace(-1.0, float(cum[-1]) + 1.0, 999)
        assert torch.equal(blocks.searchsorted_left(cum.to(cuda), q.to(cuda)).cpu(),
                           blocks.searchsorted_left(cum, q))
        for alloc in (blocks.AdaptiveAllocation(n_is=64),
                      blocks.AdaptiveAllocation(n_is=64, target_ratio=0.02),
                      blocks.AdaptiveAvgAllocation(n_is=64)):
            stats = {"profile": klp, "total": klp.sum()}
            cstats = {k: v.to(cuda) for k, v in stats.items()}
            b = int(alloc.select_bucket(stats, 28160))
            assert int(alloc.select_bucket(cstats, 28160)) == b
            for tmpl in alloc.bucket_plans(28160)[::2]:
                want = alloc.finalize_plan(tmpl, stats, 28160)
                got = alloc.finalize_plan(tmpl, cstats, 28160)
                if want.seg_ids is not None:
                    assert torch.equal(got.seg_ids.cpu(), want.seg_ids)
                    assert int(got.billable_blocks) == int(want.billable_blocks)


SMALL = dict(n_train=400, n_test=100, hw=6, widths=(32,), local_epochs=1)


def _cpu_twin(task, shards):
    from repro_torch import convert
    return (convert.mask_task(task.w0_flat.cpu(), task.x_test.cpu(), task.y_test.cpu(),
                              dims=task.net.dims, device="cpu",
                              local_epochs=task.local_epochs, lr=task.lr,
                              batch_size=task.batch_size),
            Dataset(shards.x.cpu(), shards.y.cpu()))


@pytest.mark.parametrize("allocation,participation", [("fixed", 1.0), ("fixed", 0.5),
                                                      ("adaptive", 1.0),
                                                      ("adaptive-avg", 1.0)])
def test_fused_run_on_the_card(cuda, allocation, participation):
    """A small GR (or, at participation 0.5, PR with jax cohorts) run as
    CUDA graphs: static plans equal the card's host loop bit for bit;
    adaptive plans pick the CPU fused run's buckets and book its bits; a
    second run captures nothing and replays every graph once a round."""
    cfg = dict(quickstart.CONFIG, **SMALL, allocation=allocation)
    task, spec, shards = quickstart.build(cuda, cfg)
    kw = {}
    if participation < 1:
        spec = bicompfl_spec("PR", allocation=quickstart.make_allocation(cfg),
                             n_is=cfg["n_is"], n_dl=3, participation=participation)
        kw["cohort_rng"] = "jax"
    eng = FLEngine(task, spec)
    before = {k: getattr(ops, k).launches for k in ("mrc_fixed_encode", "segment_mrc_encode")}
    fused = eng.run(shards, rounds=3, mode="fused", **kw)
    assert fused["mode"] == "fused"
    assert any(getattr(ops, k).launches > v for k, v in before.items())
    captured, replays = eng.fused_capture_count, eng.fused_replay_count
    again = eng.run(shards, rounds=3, mode="fused", **kw)
    graphs_a_round = 3      # train, codec, eval; or stats, a bucket, eval
    assert eng.fused_capture_count == captured
    assert eng.fused_replay_count - replays == 3 * graphs_a_round
    assert torch.equal(again["theta"], fused["theta"]) and again["meter"] == fused["meter"]
    if allocation == "fixed":
        host = FLEngine(task, spec).run(shards, rounds=3, mode="host", **kw)
        assert host["history"] == fused["history"] and host["meter"] == fused["meter"]
        assert torch.equal(host["theta"], fused["theta"])
        assert torch.equal(host["theta_hat"], fused["theta_hat"])
    else:
        ctask, cshards = _cpu_twin(task, shards)
        cspec = bicompfl_spec("GR", allocation=quickstart.make_allocation(cfg),
                              n_is=cfg["n_is"])
        cpu = FLEngine(ctask, cspec).run(cshards, rounds=3, mode="fused")
        assert fused["buckets"] == cpu["buckets"] and fused["meter"] == cpu["meter"]


# ---------------------------------------------------------------------------
# The MoE routing and the Mamba mixer (plain torch, no kernel of their own):
# the card's run against the port's CPU run at a mid size.  The CPU run is
# tied to the JAX reference by test_torch_moe.py and test_torch_jamba.py.
# ---------------------------------------------------------------------------

import dataclasses  # noqa: E402

from repro_torch import configs as model_configs  # noqa: E402
from repro_torch.models import mamba as mamba_mod  # noqa: E402
from repro_torch.models import moe as moe_mod  # noqa: E402

# Expert choices may differ card vs CPU only for a token whose k + 1
# largest probabilities hold two within 2 max |dprob| (+ one f32 rounding)
# of each other, and such tokens stay a small share.
MAX_NEAR_TIE_SHARE = 0.02
# f32 products and the libraries' exp/log1p in two orders, through a
# recurrence of 300 tokens; relative to the largest entry.
MODEL_RTOL = 1e-5


def _moe_cfg(**kw):
    return dataclasses.replace(model_configs.get("kimi-k2-1t-a32b").reduced(), **kw)


def _close_to_max(got, want, rtol):
    got, want = got.cpu().float(), want.float()
    assert got.shape == want.shape
    tol = rtol * max(1.0, float(want.abs().max()))
    assert float((got - want).abs().max()) <= tol


@pytest.mark.parametrize("e,k,groups", [(64, 8, 3), (384, 8, 2), (16, 2, 4)])
def test_moe_routing_on_card_matches_cpu(cuda, e, k, groups):
    """Groups of 1024 at capacity factor 1 (C = G k / E + 1: assignments drop)."""
    cfg = _moe_cfg(d_model=512, n_experts=e, top_k=k, capacity_factor=1.0)
    gen = torch.Generator(device=cuda).manual_seed(e + k)
    router = 512 ** -0.5 * torch.randn(512, e, generator=gen, device=cuda)
    xg = torch.randn(groups, 1024, 512, generator=gen, device=cuda)
    card = moe_mod.route(cfg, router, xg)
    cpu = moe_mod.route(cfg, router.cpu(), xg.cpu())
    tol = 2 * float((card.probs.cpu() - cpu.probs).abs().max()) \
        + torch.finfo(torch.float32).eps
    top = torch.sort(cpu.probs, dim=-1, descending=True).values[..., :k + 1]
    gap = (top[..., :-1] - top[..., 1:]).min(-1).values
    assert int((gap <= tol).sum()) <= MAX_NEAR_TIE_SHARE * gap.numel()
    card_idx = card.gate_idx.cpu()
    diff = (card_idx != cpu.gate_idx).any(-1)
    assert not bool((diff & (gap > tol)).any())
    # a flip moves only the places in the queues of the experts it names
    touched = torch.zeros(groups, e, dtype=torch.bool)
    for g, t in diff.nonzero().tolist():
        touched[g, card_idx[g, t]] = True
        touched[g, cpu.gate_idx[g, t]] = True
    clean = ~torch.gather(touched, 1, cpu.gate_idx.reshape(groups, -1)).reshape(
        cpu.gate_idx.shape)
    assert torch.equal(card.keep.cpu()[clean], cpu.keep[clean])
    assert torch.equal(card.pos.cpu()[clean], cpu.pos[clean])
    assert not bool(cpu.keep.all())
    _close_to_max(card.probs, cpu.probs, 1e-6)


def test_moe_top_k_on_card_keeps_the_lower_index_among_ties(cuda):
    probs = torch.full((5, 384), 1.0 / 384, device=cuda)
    probs[1, 200:] = 2.0 / 384
    vals, idx = moe_mod.top_k(probs, 8)
    assert torch.equal(idx[0].cpu(), torch.arange(8))
    assert torch.equal(idx[1].cpu(), torch.arange(200, 208))
    assert bool((vals[0] == probs[0, 0]).all())


def test_moe_ffn_on_card_matches_cpu(cuda):
    cfg = _moe_cfg(d_model=256, n_experts=16, top_k=2, moe_d_ff=512)
    params = moe_mod.init_moe(torch.Generator(device=cuda).manual_seed(3), cfg)
    x = torch.randn(2, 300, 256, generator=torch.Generator(device=cuda).manual_seed(4),
                    device=cuda)
    y, aux = moe_mod.moe_ffn(cfg, params, x)
    y_cpu, aux_cpu = moe_mod.moe_ffn(cfg, {n: t.cpu() for n, t in params.items()}, x.cpu())
    _close_to_max(y, y_cpu, MODEL_RTOL)
    _close_to_max(aux, aux_cpu, MODEL_RTOL)


def test_mamba_block_and_decode_on_card_match_cpu(cuda):
    """From a nonzero state: the block over 300 tokens, card vs CPU, and
    the card's decode steps against its own block over the first 8."""
    cfg = dataclasses.replace(model_configs.get("jamba-v0.1-52b").reduced(), d_model=512)
    gen = torch.Generator(device=cuda).manual_seed(5)
    params = mamba_mod.init_mamba(gen, cfg)
    state = mamba_mod.MambaState(
        conv=torch.randn(2, cfg.mamba_d_conv - 1, cfg.d_inner, generator=gen, device=cuda),
        ssm=0.1 * torch.randn(2, cfg.d_inner, cfg.mamba_d_state, generator=gen, device=cuda))
    x = 0.5 * torch.randn(2, 300, 512, generator=gen, device=cuda)
    y, st = mamba_mod.mamba_block(cfg, params, x, state)
    cpu = {n: t.cpu() for n, t in params.items()}
    y_cpu, st_cpu = mamba_mod.mamba_block(
        cfg, cpu, x.cpu(), mamba_mod.MambaState(*(t.cpu() for t in state)))
    _close_to_max(y, y_cpu, MODEL_RTOL)
    for a, b in zip(st, st_cpu):
        _close_to_max(a, b, MODEL_RTOL)
    pre, _ = mamba_mod.mamba_block(cfg, params, x[:, :8], state)
    outs = []
    for t in range(8):
        o, state = mamba_mod.decode_step(cfg, params, x[:, t:t + 1], state)
        outs.append(o)
    _close_to_max(torch.cat(outs, 1), pre.cpu(), MODEL_RTOL)


# ---------------------------------------------------------------------------
# M-RoPE and image inputs (Qwen2-VL), frame inputs (HuBERT), the int8 KV
# cache, the CNN: card against the port's CPU route.
# ---------------------------------------------------------------------------

from repro_torch.fl import nets  # noqa: E402
from repro_torch.models import layers as layers_mod  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

# Logits of a reduced model in f32, card against CPU, relative to the
# largest entry: the flash kernel against the chunked scan, matmuls in
# another order.
LOGITS_RTOL = 1e-4


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,causal", [((2, 300, 300, 16, 16, 80), False),
                                          ((1, 300, 450, 4, 4, 80), False),
                                          ((2, 200, 200, 4, 2, 80), True)])
def test_flash_attention_kernel_at_head_dim_80(cuda, shape, causal, dtype):
    """HuBERT's head size: the f32 kernel's third 32-column panel holding 16
    columns, and the bf16 kernel's second 64-column panel holding 16 columns
    (TMA zero-fills the rest)."""
    q, k, v = _flash_inputs(*shape, dtype=dtype, device=cuda, seed=sum(shape) + 2)
    kw = dict(causal=causal, window=0, scale=80 ** -0.5)
    got = fa.flash_attention_cuda(q, k, v, **kw)
    torch.cuda.synchronize()
    _assert_attn_close(got, q, k, v, **kw)


def test_quantize_kv_on_card_equals_cpu(cuda):
    """Payloads and f16 scale bits equal, Dh 128 and Dh 40."""
    gen = torch.Generator(device=cuda).manual_seed(6)
    for shape in ((4, 512, 8, 128), (2, 33, 4, 40)):
        x = 3 * torch.randn(shape, generator=gen, device=cuda)
        q, s = layers_mod.quantize_kv(x)
        q_cpu, s_cpu = layers_mod.quantize_kv(x.cpu())
        assert torch.equal(q.cpu(), q_cpu)
        assert torch.equal(s.cpu().view(torch.int16), s_cpu.view(torch.int16))
        assert torch.equal(layers_mod.dequantize_kv(q, s).cpu(),
                           layers_mod.dequantize_kv(q_cpu, s_cpu))


# M-RoPE card vs CPU, relative L2: each device's pow, cos and sin round
# differently, and the angles reach thousands of radians at prefill
# positions, where an ulp of the inverse frequency moves the angle by ~1e-4.
MROPE_REL_L2 = 1e-6


def _grid_positions(b, s, n_img, side, device):
    """Qwen2-VL's ids: patch i < n_img at (0, i // side, i % side), text
    token j at t = h = w = side + j - n_img."""
    i = torch.arange(s, device=device)
    text = side + i - n_img
    return torch.stack([torch.where(i < n_img, 0, text), torch.where(i < n_img, i // side, text),
                        torch.where(i < n_img, i % side, text)], -1)[None].expand(b, s, 3)


def test_apply_mrope_on_card_matches_cpu(cuda):
    """Qwen2-VL's prefill positions: 1024 patches on a 32 x 32 grid, then text."""
    x = torch.randn(2, 4096, 8, 128, generator=torch.Generator(device=cuda).manual_seed(7),
                    device=cuda)
    pos = _grid_positions(2, 4096, 1024, 32, cuda)
    got = layers_mod.apply_mrope(x, pos, 1e6, (16, 24, 24)).cpu()
    want = layers_mod.apply_mrope(x.cpu(), pos.cpu(), 1e6, (16, 24, 24))
    assert float(torch.linalg.vector_norm(got - want) / torch.linalg.vector_norm(want)) \
        <= MROPE_REL_L2


def _to_cpu(tree):
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_cpu(v) for v in tree]
    return tree.cpu()


@pytest.mark.parametrize("arch", ["qwen2-vl-72b", "hubert-xlarge"])
def test_multimodal_forward_on_card_matches_cpu(cuda, arch):
    """Reduced Qwen2-VL (16 image embeddings, grid positions) and HuBERT
    (frames, non-causal) in f32: the card's flash kernel against the CPU."""
    cfg = model_configs.get(arch).reduced()
    model = T.build(cfg)
    params = T.init_params(model, seed=0, device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(8)
    if cfg.embed_inputs:
        n = cfg.vlm_image_tokens
        pos = _grid_positions(2, 40, n, 4, cuda)
        batch = {"tokens": torch.randint(0, cfg.vocab, (2, 40), generator=gen, device=cuda),
                 "image_embeds": 0.02 * torch.randn(2, n, cfg.d_model, generator=gen,
                                                    device=cuda),
                 "positions": pos}
    else:
        batch = {"inputs": 0.02 * torch.randn(2, 40, cfg.d_model, generator=gen, device=cuda)}
    before = ops.flash_attention.launches
    got = T.forward(model, params, batch)
    assert ops.flash_attention.launches == before + cfg.n_layers
    want = T.forward(model, _to_cpu(params), _to_cpu(batch))
    _close_to_max(got, want, LOGITS_RTOL)


def test_cnn_on_card_matches_cpu(cuda):
    """TF32 stays off: cuDNN's f32 convolutions against the CPU's."""
    assert not torch.backends.cudnn.allow_tf32 and not torch.backends.cuda.matmul.allow_tf32
    net = nets.make_cnn(hw=14, channels=3, signed_constant=False, device=cuda)
    weights = net.init(prng.PRNGKey(9, device=cuda))
    x = torch.randn(64, 14, 14, 3, generator=torch.Generator(device=cuda).manual_seed(9),
                    device=cuda)
    got = net(x)
    want = nets.make_cnn(hw=14, channels=3, device="cpu")(x.cpu(), [w.cpu() for w in weights])
    _close_to_max(got, want, 1e-5)


# ---------------------------------------------------------------------------
# Training: the two model kernels' Functions differentiated, the sign draw,
# a train step, card against CPU.
# ---------------------------------------------------------------------------

from repro_torch import convert  # noqa: E402
from repro_torch.launch import train as train_mod  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

# Gradients card vs CPU: the same plain backward (a recomputed chunked scan)
# in two libraries' summation orders, f32 with TF32 off.
GRAD_RTOL = 1e-5


def _grads_through(fn, inputs, weight):
    """(output, d sum(output * weight) / d inputs) through ``fn``."""
    leaves = [t.detach().clone().requires_grad_() for t in inputs]
    out = fn(*leaves)
    return out.detach(), torch.autograd.grad((out.float() * weight).sum(), leaves)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,causal,window,kv_chunk", [
    ((2, 128, 128, 4, 2, 64), True, 0, 128), ((1, 200, 200, 4, 4, 80), False, 0, 64),
    ((2, 96, 96, 4, 2, 128), True, 32, 1024)])
def test_flash_attention_backward_on_card_matches_cpu(cuda, shape, causal, window, kv_chunk,
                                                      dtype):
    """``ops.flash_attention`` differentiated: the forward launches the kernel
    once (the backward none) and the gradients equal the CPU route's."""
    q, k, v = _flash_inputs(*shape, dtype=dtype, device=cuda, seed=sum(shape) + 7)
    kw = dict(causal=causal, window=window, scale=shape[-1] ** -0.5, kv_chunk=kv_chunk)
    weight = torch.randn(q.shape, device=cuda)

    def fn(*t):
        return ops.flash_attention(*t, **kw)

    before = ops.flash_attention.launches
    out, grads = _grads_through(fn, (q, k, v), weight)
    assert ops.flash_attention.launches == before + 1
    out_cpu, grads_cpu = _grads_through(fn, [t.cpu() for t in (q, k, v)], weight.cpu())
    _assert_attn_close(out, q, k, v, **{n: kw[n] for n in ("causal", "window", "scale")})
    for g, w in zip(grads, grads_cpu):
        assert g.dtype == dtype
        # bf16 gradients: one bf16 ulp of each entry on top
        tol = GRAD_RTOL * w.float().abs().max() + (
            _bf16_ulp(w) if dtype == torch.bfloat16 else 0)
        assert bool(((g.cpu().float() - w.float()).abs() <= tol).all())


@pytest.mark.parametrize("b,s,h", [(2, 130, 2), (1, 64, 4)])
def test_rwkv_backward_on_card_matches_cpu(cuda, b, s, h):
    r, k, v, logw, u = _rwkv_inputs(b, s, h, torch.float32, cuda, seed=b + s)
    weight = torch.randn(r.shape, device=cuda)
    before = ops.rwkv_time_mix.launches
    out, grads = _grads_through(ops.rwkv_time_mix, (r, k, v, logw, u), weight)
    assert ops.rwkv_time_mix.launches == before + 1
    _, grads_cpu = _grads_through(ops.rwkv_time_mix, [t.cpu() for t in (r, k, v, logw, u)],
                                  weight.cpu())
    for g, w in zip(grads, grads_cpu):
        _close_to_max(g, w, GRAD_RTOL)


def test_sign_draw_on_card_equals_cpu(cuda):
    """The stochastic sign's Bernoulli bits, drawn in ranges on the card,
    equal the CPU's on the same probabilities and key."""
    p = torch.rand(3 * train_mod.SIGN_DRAW_RANGE // 2 + 77, device=cuda)
    key = prng.fold_in(prng.PRNGKey(5, device=cuda), 3)
    got = train_mod._bernoulli(key, p)
    assert torch.equal(got.cpu(), train_mod._bernoulli(key.cpu(), p.cpu()))


def test_train_step_on_card_matches_cpu(cuda):
    """Two steps of the reduced qwen3 (f32, microbatches 2, sign
    compression) from the same weights: losses and parameters card vs CPU
    (parameters within 1e-2 lr but at entries whose sign flipped)."""
    cfg = model_configs.get("qwen3-1.7b").reduced()
    model = T.build(cfg)
    params = convert.stack_model_params(model, T.init_params(model, seed=3, device="cpu"))
    runs = {}
    for dev in ("cpu", cuda):
        tr = train_mod.Trainer(cfg, lr=1e-3, microbatches=2, kv_chunk=32,
                               grad_compression="stochastic_sign", device=dev,
                               params=tree_map(lambda t: t.to(dev), params))
        gen = np.random.default_rng(4)
        losses = [tr.step({"tokens": gen.integers(0, cfg.vocab, (4, 32)),
                           "labels": gen.integers(0, cfg.vocab, (4, 32))}) for _ in range(2)]
        runs[str(dev)] = losses, [t.cpu() for t in tree_leaves(tr.params)]
    (l_cpu, p_cpu), (l_card, p_card) = runs["cpu"], runs[str(cuda)]
    assert l_card == pytest.approx(l_cpu, rel=1e-5)
    far = sum(int(((a - b).abs() > 1e-5).sum()) for a, b in zip(p_card, p_cpu))
    assert far <= 1e-4 * sum(t.numel() for t in p_cpu), far


def test_kernel_wrappers_report_their_work_to_op_cost(cuda):
    """A kernel launched through ``ops`` inside ``launch.op_cost.OpCost``
    reports its ``kernels.cost`` formula (the dispatcher sees no ctypes
    call), once a launch, inside the wrapper's region; the plain route on
    the CPU reports nothing and is counted op by op instead."""
    from repro_torch.kernels import cost
    from repro_torch.launch import op_cost

    gen = torch.Generator(device=cuda).manual_seed(3)
    q = torch.randn(2, 128, 4, 32, generator=gen, device=cuda)
    k, v = (torch.randn(2, 128, 2, 32, generator=gen, device=cuda) for _ in range(2))
    r, kk, vv = (torch.randn(1, 64, 2, 64, generator=gen, device=cuda) for _ in range(3))
    logw = -torch.rand(1, 64, 2, 64, generator=gen, device=cuda)
    u = torch.randn(2, 64, generator=gen, device=cuda)
    x, a, b = _logw_inputs(7, 48, 100, seed=1, device=cuda)
    pq, pp = (torch.rand(3, 1001, generator=gen, device=cuda) for _ in range(2))
    cases = [("flash_attention", lambda: ops.flash_attention(q, k, v, causal=True, window=16),
              cost.flash_attention(q, k, v, True, 16)),
             ("rwkv_time_mix", lambda: ops.rwkv_time_mix(r, kk, vv, logw, u),
              cost.rwkv_time_mix(r, kk, vv, logw, u)),
             ("mrc_logw", lambda: ops.mrc_logw(x, a, b), cost.mrc_logw(x, a, b)),
             ("bernoulli_kl", lambda: ops.bernoulli_kl(pq, pp), cost.bernoulli_kl(pq, pp)),
             ("bernoulli_kl_total", lambda: ops.bernoulli_kl_total(pq, pp),
              cost.bernoulli_kl_total(pq, pp)),
             ("bernoulli_kl_profile", lambda: ops.bernoulli_kl_profile(pq, pp),
              cost.bernoulli_kl_profile(pq, pp))]
    for name, call, work in cases:
        with op_cost.OpCost() as oc:
            with op_cost.repeat(3):
                call()
        torch.cuda.synchronize()
        assert oc.totals.ops[f"kernel:{name}"] == 3, name
        assert oc.totals.flops_by_region[name] == 3 * work.flops, name
        assert oc.totals.flops == 3 * work.flops, name
    with op_cost.OpCost() as oc:
        ops.flash_attention(q.cpu(), k.cpu(), v.cpu(), causal=True, window=16)
    assert "kernel:flash_attention" not in oc.totals.ops
    assert oc.totals.flops_by_region["flash_attention"] > 0


def test_spans_time_the_card_and_record_no_event_in_a_capture(cuda):
    """A span on the card gets its device time from CUDA events; inside a
    graph capture it records none (host times only), and the captured
    work is unchanged; a kernel launch through ``ops`` is ``kernel.<name>``
    inside its caller's span."""
    from repro_torch import spans
    spans.clear()
    x = torch.randn(1 << 20, device=cuda)
    side, graph = torch.cuda.Stream(), torch.cuda.CUDAGraph()
    q, p = torch.rand(8, 4096, device=cuda), torch.rand(8, 4096, device=cuda)
    with spans.recording():
        with spans.span("eager", cuda):
            y = x * 2
            ops.bernoulli_kl(q, p)
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            x * 3                                   # warm-up outside the capture
        torch.cuda.current_stream().wait_stream(side)
        with torch.cuda.graph(graph, stream=side):
            with spans.span("captured", cuda):
                z = x * 3
        with spans.span("replay", cuda):
            graph.replay()
    recs = spans.records()
    by = {r.name: r for r in recs}
    assert by["eager"].device_ms > 0 and by["replay"].device_ms > 0
    assert by["captured"].device_ms is None and by["captured"].host_ms > 0
    assert recs[by["kernel.bernoulli_kl"].parent].name == "eager"
    assert by["kernel.bernoulli_kl"].device_ms is not None
    assert torch.equal(y, x * 2) and torch.equal(z, x * 3)
    spans.clear()


# ---------------------------------------------------------------------------
# prng's draws: one launch of csrc/threefry_draw.cu each, bit for bit
# prng's int64 route (prng.draw_int64) run on the same card.
# ---------------------------------------------------------------------------

from repro_torch.kernels import threefry_draw as tfd  # noqa: E402


def _on_int64_route(monkeypatch):
    """Every prng draw from here on takes the plain int64 route, on the card."""
    monkeypatch.setattr(ops, "threefry_draw",
                        lambda key, at, ndim=0, out="bits", p=None:
                        prng.draw_int64(key, at, ndim, out, p))


def _draw_cases():
    """name -> f(device): the draws of the cells' shapes and prng's callers."""
    def keys(dev, seed, *batch):
        k = prng.PRNGKey(seed, device=dev)
        return prng.split(k, batch) if batch else k

    def sign_range(k, lo_shift=0, n=2 ** 24):
        lo = k * 2 ** 24 + lo_shift
        return lambda dev: prng.uniform_at(keys(dev, 9), torch.arange(lo, lo + n, device=dev))

    return {
        # the STE's mask: keys (10, 2) strided out of (10, 138, 2), p (10, 203264)
        "bernoulli-ste": lambda dev: prng.bernoulli(
            prng.split(keys(dev, 1, 10), 138)[:, 5],
            prng.uniform(keys(dev, 2, 10), (203264,))),
        "bernoulli-ragged-one-key": lambda dev: prng.bernoulli(
            keys(dev, 3), prng.uniform(keys(dev, 4), (7, 1001))),
        "bernoulli-bf16-p": lambda dev: prng.bernoulli(
            keys(dev, 5, 4), prng.uniform(keys(dev, 6), (4, 512)).to(torch.bfloat16)),
        # the stochastic sign's ranges [k 2^24, (k + 1) 2^24), below and past 2^32
        "uniform_at-range-0": sign_range(0),
        "uniform_at-range-135": sign_range(135),
        "uniform_at-range-256": sign_range(256),
        "uniform_at-range-300": sign_range(300),
        "uniform_at-past-2^32-ragged": lambda dev: prng.uniform_at(
            keys(dev, 10, 3), torch.arange(2 ** 32 - 1000, 2 ** 32 + 12345, device=dev)[3:]),
        "uniform_at-decoder-rows": lambda dev: mrc._selected_candidate(
            keys(dev, 11), torch.arange(10 * 1588, device=dev).reshape(10, 1588) % 64, 128),
        "split": lambda dev: (prng.split(keys(dev, 12, 10), 138), prng.split(keys(dev, 13), (2, 3)),
                              prng.split(keys(dev, 14, 10), 2)),
        "fold_in": lambda dev: (prng.fold_in(keys(dev, 15, 10), 2 ** 32 - 1),
                                prng.fold_in(keys(dev, 16), 7),
                                prng.fold_in(keys(dev, 17), torch.arange(1588, device=dev)),
                                prng.fold_in(keys(dev, 18, 10)[:, None, :],
                                             torch.arange(1588, device=dev))),
        "randint": lambda dev: prng.randint(keys(dev, 19, 10), (138, 128), 0, 6000),
        "uniform-normal-gumbel": lambda dev: (prng.uniform(keys(dev, 20, 10), (64, 128)),
                                              prng.normal(keys(dev, 21), (3, 333)),
                                              prng.gumbel(keys(dev, 22), (5, 77)),
                                              prng.random_bits(keys(dev, 23, 2), (9, 31))),
        "choice-permutation": lambda dev: (prng.choice(keys(dev, 24), 10, (5,), replace=False),
                                           prng.permutation(keys(dev, 25, 3), 1000)),
    }


def _flat_bits(out):
    outs = out if isinstance(out, tuple) else (out,)
    return [t.view(torch.int32) if t.dtype == torch.float32 else t for t in outs]


@pytest.mark.parametrize("name", list(_draw_cases()))
def test_prng_draws_on_card_equal_the_int64_route(cuda, monkeypatch, name):
    fn = _draw_cases()[name]
    before = ops.threefry_draw.launches
    got = fn(cuda)
    assert ops.threefry_draw.launches > before
    _on_int64_route(monkeypatch)
    want = fn(cuda)
    torch.cuda.synchronize()
    for g, w in zip(_flat_bits(got), _flat_bits(want)):
        assert g.shape == w.shape and g.dtype == w.dtype and torch.equal(g, w)


def test_prng_draws_capture_into_a_cuda_graph(cuda, monkeypatch):
    """Captured once and replayed on new keys and probabilities, the draws
    equal the int64 route's on those inputs; a replay runs no Python."""
    key = prng.PRNGKey(31, device=cuda)
    mk = prng.split(prng.split(key, 10), 138)[:, 7].clone()    # static inputs
    p = prng.uniform(prng.fold_in(key, 1), (10, 203264))
    counts = torch.arange(135 * 2 ** 24, 135 * 2 ** 24 + (1 << 20), device=cuda)

    def draws():
        return (prng.bernoulli(mk, p), prng.uniform_at(key, counts), prng.split(mk, 138),
                prng.fold_in(key, 3), prng.randint(mk, (138, 128), 0, 6000))

    side, graph = torch.cuda.Stream(), torch.cuda.CUDAGraph()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        draws()                                                  # warm-up
    torch.cuda.current_stream().wait_stream(side)
    before = ops.threefry_draw.launches
    with torch.cuda.graph(graph, stream=side):
        captured = draws()
    assert ops.threefry_draw.launches - before == 1 + 1 + 1 + 1 + 3
    for seed in (32, 33):
        fresh = prng.PRNGKey(seed, device=cuda)
        key.copy_(fresh)
        mk.copy_(prng.split(prng.split(fresh, 10), 138)[:, 7])
        p.copy_(prng.uniform(prng.fold_in(fresh, 1), (10, 203264)))
        launched = ops.threefry_draw.launches
        graph.replay()
        torch.cuda.synchronize()
        assert ops.threefry_draw.launches == launched
        with monkeypatch.context() as m:
            _on_int64_route(m)
            want = draws()
        for g, w in zip(_flat_bits(captured), _flat_bits(want)):
            assert torch.equal(g, w)


def test_fused_gr_round_captures_one_mask_draw_per_ste_step(cuda, monkeypatch):
    """The fused GR round's train graph holds one ``threefry_draw`` launch
    per STE step for the masks (made once eagerly, once in the capture);
    a second run replays and makes no draw in Python."""
    seen = []
    kernel = tfd.threefry_draw_cuda

    def spy(key, at, ndim=0, out="bits", p=None):
        seen.append((out, torch.cuda.is_current_stream_capturing()))
        return kernel(key, at, ndim, out, p)

    monkeypatch.setattr(tfd, "threefry_draw_cuda", spy)
    cfg = dict(quickstart.CONFIG, **dict(SMALL, local_epochs=3), allocation="fixed")
    task, spec, shards = quickstart.build(cuda, cfg)
    shard = shards.y.shape[1]
    n_steps = task.local_epochs * max(shard // min(task.batch_size, shard), 1)
    eng = FLEngine(task, spec)
    seen.clear()
    fused = eng.run(shards, rounds=2, mode="fused")
    masks = [c for o, c in seen if o == "bernoulli"]
    assert masks.count(True) == n_steps and masks.count(False) == n_steps
    seen.clear()
    again = eng.run(shards, rounds=2, mode="fused")
    assert not [o for o, _ in seen if o == "bernoulli"]
    assert torch.equal(again["theta"], fused["theta"])
    host = FLEngine(task, spec).run(shards, rounds=2, mode="host")
    assert torch.equal(host["theta"], fused["theta"]) and host["meter"] == fused["meter"]
