"""The port's CUDA kernels on the card, against their plain PyTorch versions.

Every test here needs an NVIDIA card and skips without one.  The file
imports neither ``jax`` nor ``repro``, so it also runs on a machine that has
only the port's dependencies:

    python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest``: ``tests/conftest.py`` imports JAX for the reference's
tests.)  The CPU tests in ``test_torch_mrc.py`` tie the plain versions to
the JAX reference.
"""
import pytest
import torch

from repro_torch import prng
from repro_torch.core import mrc
from repro_torch.core.bernoulli import log_ratio_coeffs
from repro_torch.kernels import ops
from repro_torch.kernels.mrc_weights import mrc_logw_cuda, mrc_logw_ref

pytestmark = pytest.mark.cuda

# fp32 S-term sums in another order than the plain version's GEMV.
LOGW_RTOL, LOGW_ATOL = 1e-5, 1e-4


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
                                   (3, 1, 1), (4, 256, 4096)])
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
