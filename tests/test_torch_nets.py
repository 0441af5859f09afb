"""The port's CNN (``repro_torch.fl.nets.make_cnn``) against the reference's
``repro.fl.nets.make_cnn`` on the CPU: the weights drawn from the same key,
and the logits on the same weights and NHWC inputs.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.fl import nets as JN

from repro_torch import prng
from repro_torch.fl import nets as N

# prng.normal's bound against jax.random.normal (tests/test_torch_prng.py):
# torch's erfinv is not XLA's.  Signs, and so signed-constant weights, are
# exact.
NORMAL_MAX_ULP = 128
# Convolutions and matmuls in f32 in another summation order.
APPLY_TOL = 1e-5
# make_cnn's defaults, and an odd width (VALID pooling drops the last row
# and column: 7 -> 3 -> 1) with three channels and two dense layers.
CNNS = {"default": dict(),
        "odd-rgb": dict(hw=7, channels=3, n_classes=5, conv_widths=(4, 8),
                        dense_widths=(16, 12))}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One torch thread for this file: its shapes are small, and the suite's
    workers share one machine."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _ulps(a, b):
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(a - b)


@functools.lru_cache(maxsize=None)
def _ref_apply(name):
    """The reference's ``apply`` (the same for both inits), compiled once."""
    return jax.jit(JN.make_cnn(**CNNS[name]).apply)


@pytest.mark.parametrize("signed_constant", [True, False])
@pytest.mark.parametrize("name", list(CNNS))
def test_cnn_init_and_apply_match_reference(name, signed_constant):
    kw = CNNS[name]
    ref = JN.make_cnn(signed_constant=signed_constant, **kw)
    want_w = jax.jit(ref.init)(jax.random.PRNGKey(3))
    net = N.make_cnn(signed_constant=signed_constant, device="cpu", **kw)
    got_w = net.init(prng.PRNGKey(3, device="cpu"))
    assert [tuple(w.shape) for w in got_w] == [tuple(w.shape) for w in want_w]
    for g, w in zip(got_w, want_w):
        if signed_constant:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        else:
            assert _ulps(g.numpy(), w).max() <= NORMAL_MAX_ULP
            np.testing.assert_array_equal(np.sign(g.numpy()), np.sign(np.asarray(w)))
    hw, ch = kw.get("hw", 14), kw.get("channels", 1)
    x = np.random.default_rng(4).standard_normal((5, hw, hw, ch)).astype(np.float32)
    want = np.asarray(_ref_apply(name)(want_w, jnp.asarray(x)))
    weights = [torch.from_numpy(np.array(w)) for w in want_w]
    got = net(torch.from_numpy(x), weights)
    np.testing.assert_allclose(got.numpy(), want, rtol=APPLY_TOL,
                               atol=APPLY_TOL * max(1.0, float(np.abs(want).max())))
    # the frozen buffers are the drawn weights
    torch.testing.assert_close(net(torch.from_numpy(x)), net(torch.from_numpy(x), got_w),
                               rtol=0, atol=0)


def test_cnn_refuses_too_many_pools():
    with pytest.raises(AssertionError, match="too many pools"):
        N.make_cnn(hw=4, conv_widths=(4, 4, 4), device="cpu")
