"""The reference's last public functions held against the port on the CPU:
``core.bernoulli.bern_kl_bits`` and ``sigmoid``, and
``fl.tasks.MaskTask.evaluate_sampled``.

Inputs are made with numpy from a seed; the mask task is the reference's,
carried across with ``repro_torch.convert``.  The sampled mask must equal
``jax.random.bernoulli``'s bit for bit, and so must the accuracy it gives.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bernoulli as jb
from repro.fl.data import make_synthetic as j_make_synthetic
from repro.fl.nets import make_mlp as j_make_mlp
from repro.fl.tasks import make_mask_task as j_make_task
from repro_torch import convert, prng
from repro_torch.core import bernoulli as tb

HW, WIDTH = 6, 32
DIMS = (HW * HW, WIDTH, 10)
# Elementwise f32 functions of two libraries (log, exp): within 1e-6 of
# the value, relative, and 1e-6 absolute near 0.
FLOAT_TOL = 1e-6


def _probs(rng, n, edges=True):
    """Uniform probabilities in [0, 1], with the clip's edges among them."""
    x = rng.uniform(0.0, 1.0, n).astype(np.float32)
    if edges:
        x[:6] = [0.0, 1.0, 1e-7, 1.0 - 1e-7, 0.5, 1e-6]
    return x


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bern_kl_bits_matches_reference(seed):
    rng = np.random.default_rng(seed)
    q, p = _probs(rng, 4096), _probs(rng, 4096)
    p[6:12] = q[6:12]                                     # KL 0
    want = np.asarray(jb.bern_kl_bits(jnp.asarray(q), jnp.asarray(p)))
    got = tb.bern_kl_bits(torch.from_numpy(q), torch.from_numpy(p))
    assert got.dtype == torch.float32 and got.shape == (4096,)
    np.testing.assert_allclose(got.numpy(), want, rtol=FLOAT_TOL, atol=FLOAT_TOL)
    # bits are nats over log 2
    nats = tb.bern_kl(torch.from_numpy(q), torch.from_numpy(p))
    np.testing.assert_allclose(got.numpy(), nats.numpy() / np.log(2.0), rtol=FLOAT_TOL)


@pytest.mark.parametrize("scale", [1.0, 10.0, 100.0])
def test_sigmoid_matches_reference(scale):
    rng = np.random.default_rng(int(scale))
    x = (scale * rng.standard_normal(4096)).astype(np.float32)
    x[:4] = [0.0, -0.0, 88.0, -88.0]
    want = np.asarray(jb.sigmoid(jnp.asarray(x)))
    got = tb.sigmoid(torch.from_numpy(x))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=FLOAT_TOL, atol=FLOAT_TOL)
    # the mirror map's inverse inside the clip
    theta = tb.sigmoid(tb.inv_sigmoid(torch.from_numpy(_probs(rng, 64, edges=False))))
    assert bool(((theta >= 0) & (theta <= 1)).all())


@pytest.fixture(scope="module")
def tasks():
    key = jax.random.PRNGKey(0)
    _, test = j_make_synthetic(key, n_train=10, n_test=200, hw=HW, noise=0.4)
    ref = j_make_task(j_make_mlp(HW * HW, (WIDTH,), signed_constant=True),
                      jax.random.fold_in(key, 2), test.x, test.y)
    port = convert.mask_task(ref.w0_flat, ref.x_test, ref.y_test, dims=DIMS, device="cpu")
    return ref, port


@pytest.mark.parametrize("theta_kind,seed", [("half", 0), ("uniform", 1), ("uniform", 2),
                                             ("edges", 3), ("peaked", 4)])
def test_evaluate_sampled_matches_reference(tasks, theta_kind, seed):
    ref, port = tasks
    rng = np.random.default_rng(seed)
    d = port.d
    theta = {"half": np.full(d, 0.5, np.float32),
             "uniform": rng.uniform(0.0, 1.0, d).astype(np.float32),
             "edges": rng.choice(np.float32([0.0, 1.0, 0.5]), d),
             "peaked": np.clip(rng.normal(0.9, 0.1, d), 0.0, 1.0).astype(np.float32)}[theta_kind]
    jkey = jax.random.fold_in(jax.random.PRNGKey(seed), 7)
    tkey = convert.key(jkey, "cpu")
    # the draw evaluate_sampled makes, bit for bit
    want_mask = np.asarray(jax.random.bernoulli(jkey, jb.clip01(jnp.asarray(theta))))
    got_mask = prng.bernoulli(tkey, tb.clip01(torch.from_numpy(theta))).numpy()
    np.testing.assert_array_equal(got_mask, want_mask)
    want = float(ref.evaluate_sampled(jnp.asarray(theta), jkey))
    got = port.evaluate_sampled(torch.from_numpy(theta), tkey)
    assert isinstance(got, float)
    assert got == want
    # theta of 0 and 1 are clipped into (0, 1): such entries are drawn as
    # off and on (a uniform below 1e-6, or at or above 1 - 1e-6, is rare)
    if theta_kind == "edges":
        on = want_mask.astype(bool)
        assert (on[theta == 1.0]).mean() > 0.99 and (on[theta == 0.0]).mean() < 0.01
