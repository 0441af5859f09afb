"""``lm_loss`` / ``encoder_loss`` and their gradients on the other reduced
configs (Kimi K2 with its MoE aux loss, RWKV-6, Jamba, Qwen2-VL, HuBERT),
and the remat path, against the JAX reference on the CPU.

The reference's ``init_params`` tree is carried into the port in its own
stacked layout (``convert.stacked_params``) and the port's loss reads it
through ``convert.params_view``, as the trainer does, so the gradients
compare leaf by leaf in the reference's layout.  The reference's
``value_and_grad`` runs under ``jax.jit``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as RC
from repro.data import batches_for as j_batches
from repro.models import transformer as JT

import repro_torch.configs as C
from repro_torch import convert
from repro_torch.launch import train as TR
from repro_torch.models import transformer as T
from repro_torch.tree import tree_leaves, tree_map

# Same functions in f32, other summation orders (and for RWKV-6 another
# algorithm: the reference's per-token scan against the port's chunked
# form): the loss within 1e-5 relative (measured <= 7e-8), each gradient
# leaf within this share of its largest entry (measured 1.0e-5 on Jamba's
# 24-step Mamba loop, <= 4.1e-6 elsewhere).
LOSS_RTOL, GRAD_TOL = 1e-5, 5e-5

# (arch, batch, seq): MoE batches stay one dropless group (B x S <= 256);
# RWKV's 72 tokens cross a 64-token chunk of the port's kernel route.
CASES = [("kimi-k2-1t-a32b", 2, 32), ("rwkv6-1.6b", 2, 72), ("jamba-v0.1-52b", 2, 24),
         ("qwen2-vl-72b", 2, 32), ("hubert-xlarge", 2, 32)]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


_PARAMS = {}


def _losses(arch, b, s, *, remat=False, aux_weight=0.01):
    """(reference loss, reference grads, port loss, port grads) at the
    reference's initial parameters, on one batch of ``data.batches_for``."""
    cfg = dataclasses.replace(RC.get(arch).reduced(), remat=remat)
    model = JT.build(cfg)
    if arch not in _PARAMS:     # remat does not change the parameters
        _PARAMS[arch] = JT.init_params(model, jax.random.PRNGKey(2))[0]
    params = _PARAMS[arch]
    batch = next(j_batches(cfg, b, s, seed=3, n=1))
    if cfg.causal:
        fn = lambda p, x: JT.lm_loss(model, p, x, aux_weight=aux_weight, kv_chunk=s)  # noqa
    else:
        fn = lambda p, x: JT.encoder_loss(model, p, x, kv_chunk=s)  # noqa: E731
    jl, jg = jax.jit(jax.value_and_grad(fn))(params,
                                             {k: jnp.asarray(v) for k, v in batch.items()})

    tmodel = T.build(dataclasses.replace(C.get(arch).reduced(), remat=remat))
    tree = tree_map(lambda t: t.requires_grad_(),
                          convert.stacked_params(jax.tree.map(np.asarray, params), "cpu"))
    view = convert.params_view(tmodel, tree)
    tb = TR.batch_tensors(batch, "cpu")
    if cfg.causal:
        tl = T.lm_loss(tmodel, view, tb, aux_weight=aux_weight, kv_chunk=s)
    else:
        tl = T.encoder_loss(tmodel, view, tb, kv_chunk=s)
    tg = torch.autograd.grad(tl, tree_leaves(tree), allow_unused=True,
                             materialize_grads=True)
    return float(jl), [np.asarray(g) for g in jax.tree.leaves(jg)], float(tl.detach()), \
        [g.numpy() for g in tg]


def _assert_grads(jg, tg):
    assert len(jg) == len(tg)
    for a, b in zip(jg, tg):
        assert a.shape == b.shape
        np.testing.assert_allclose(b, a, rtol=0, atol=GRAD_TOL * max(np.abs(a).max(), 1e-30))


@pytest.mark.parametrize("arch,b,s", CASES)
def test_loss_and_grads_match_reference(arch, b, s):
    jl, jg, tl, tg = _losses(arch, b, s)
    assert tl == pytest.approx(jl, rel=LOSS_RTOL)
    _assert_grads(jg, tg)


def test_moe_aux_loss_enters_loss_and_grads():
    """Kimi K2: the load-balance term is in the loss (its weight moves the
    loss by the reference's amount) and in the router's gradient."""
    jl0, jg0, tl0, tg0 = _losses("kimi-k2-1t-a32b", 2, 32, aux_weight=0.0)
    jl1, _, tl1, tg1 = _losses("kimi-k2-1t-a32b", 2, 32, aux_weight=1.0)
    assert tl1 - tl0 == pytest.approx(jl1 - jl0, rel=1e-4)
    assert jl1 - jl0 > 0
    _assert_grads(jg0, tg0)
    assert any(not np.array_equal(a, b) for a, b in zip(tg0, tg1))


def test_remat_matches_reference_and_no_remat():
    """``cfg.remat`` (every full config's setting): each pattern layer under
    ``torch.utils.checkpoint`` gives the reference's remat gradients, and
    the port's own gradients without remat bit for bit."""
    jl, jg, tl, tg = _losses("qwen3-1.7b", 2, 32, remat=True)
    assert tl == pytest.approx(jl, rel=LOSS_RTOL)
    _assert_grads(jg, tg)
    _, _, tl0, tg0 = _losses("qwen3-1.7b", 2, 32, remat=False)
    assert tl0 == tl
    for a, b in zip(tg0, tg):
        np.testing.assert_array_equal(a, b)

