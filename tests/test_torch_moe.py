"""The port's MoE FFN (``repro_torch.models.moe``) and the MoE configs
(Kimi K2, Llama 4 Maverick) against the JAX reference on the CPU.

Inputs are made with numpy from a seed and handed to both packages; the
reference's weights are carried into the port by ``convert.model_params``.
Routing is discrete, so expert choices, queue positions and drops must be
equal; every float is held within a tolerance stated where it is used.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as RC
from repro.launch.serve import Request as JRequest
from repro.launch.serve import Server as JServer
from repro.models import moe as JM
from repro.models import transformer as JT

import repro_torch.configs as C
from repro_torch import convert
from repro_torch.launch.serve import Request, Server
from repro_torch.models import moe as M
from repro_torch.models import transformer as T
from repro_torch.models.config import ArchConfig

# Same algorithm in both packages, f32 throughout: only the summation order
# of the matmuls and the library's exp differ (a few ulp of O(1) values).
SAME_ALGO_TOL = 1e-5
# Logits of a 2-layer model, relative to their largest entry (as in
# test_torch_models.py).
MODEL_TOL = 1e-4
ARCHS = ["kimi-k2-1t-a32b", "llama4-maverick-400b-a17b"]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One torch thread for this file: its shapes are small, and the suite's
    workers share one machine, where each worker's threads on every core
    oversubscribe it many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(x):
    return torch.from_numpy(np.array(np.asarray(x, np.float32)))


def _close(got, want, tol, rel_to_max=False):
    got = got.detach().to(torch.float32).numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    atol = tol * max(1.0, float(np.abs(want).max())) if rel_to_max else tol
    np.testing.assert_allclose(got, want, rtol=tol, atol=atol)


def _mine(cfg):
    return ArchConfig(**dataclasses.asdict(cfg))


def _ref_routing(cfg, router, x, group=1024):
    """``repro.models.moe.moe_ffn``'s routing, lines 100-130, as it stands
    there: (probs, gate_vals, gate_idx, keep (n, G, k), pos (n, G, k), the
    grouped inputs)."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    g = min(group, b * s)
    n_tok = b * s
    n_groups = -(-n_tok // g)
    xt = x.reshape(n_tok, d)
    pad = n_groups * g - n_tok
    if pad:
        xt = jnp.pad(xt, ((0, pad), (0, 0)))
    xg = xt.reshape(n_groups, g, d)
    logits = (xg.astype(jnp.float32) @ router)
    probs = jax.nn.softmax(logits, axis=-1)
    gate_vals, gate_idx = jax.lax.top_k(probs, k)
    gate_vals = gate_vals / jnp.maximum(jnp.sum(gate_vals, axis=-1, keepdims=True), 1e-9)
    c = JM._capacity(cfg, g)
    onehot = jax.nn.one_hot(gate_idx, e, dtype=jnp.float32)
    pos = jnp.cumsum(onehot.reshape(n_groups, g * k, e), axis=1).reshape(
        n_groups, g, k, e) - 1.0
    keep = (pos < c) & (onehot > 0)
    pos = jnp.sum(pos * onehot, axis=-1)
    return probs, gate_vals, gate_idx, keep.any(-1), pos.astype(jnp.int32), xg


def _moe_cfg(arch, **kw):
    return dataclasses.replace(RC.get(arch).reduced(), **kw)


# (config, (B, S), capacity_factor, zero inputs).  B * S <= 256 is one
# dropless group; (2, 600) is 2 groups of 1024 with 848 padding rows, at
# capacity_factor 0.5 so that assignments are dropped; (4, 1) is a decode
# step's group; zero inputs make every probability 1/E, pinning the tie-break.
CASES = {
    "kimi": ("kimi-k2-1t-a32b", {}, (2, 72), False),
    "llama4": ("llama4-maverick-400b-a17b", {}, (2, 72), False),
    "jamba": ("jamba-v0.1-52b", {}, (2, 72), False),
    "e16-k8": ("kimi-k2-1t-a32b", dict(n_experts=16, top_k=8), (2, 72), False),
    "decode-group": ("kimi-k2-1t-a32b", dict(n_experts=16, top_k=8), (4, 1), False),
    "dropless-256": ("jamba-v0.1-52b", {}, (2, 128), False),
    "padded-drops": ("kimi-k2-1t-a32b", dict(n_experts=16, top_k=4, capacity_factor=0.5),
                     (2, 600), False),
    "zeros": ("kimi-k2-1t-a32b", dict(n_experts=16, top_k=8), (2, 40), True),
    "zeros-padded-drops": ("llama4-maverick-400b-a17b",
                           dict(n_experts=8, top_k=1, capacity_factor=0.5), (2, 600), True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_routing_and_moe_ffn_match_reference(case):
    arch, changes, (b, s), zeros = CASES[case]
    cfg = _moe_cfg(arch, **changes)
    params, _ = JM.init_moe(jax.random.PRNGKey(3), cfg)
    x = np.zeros((b, s, cfg.d_model), np.float32) if zeros else \
        np.random.default_rng(b * s).standard_normal((b, s, cfg.d_model)).astype(np.float32)
    c = JM._capacity(cfg, min(1024, b * s))
    probs, gate_vals, gate_idx, keep, pos, xg = jax.jit(
        lambda r, x: _ref_routing(cfg, r, x))(params["router"], jnp.asarray(x))
    mine = _mine(cfg)
    r = M.route(mine, _t(params["router"]), _t(xg))
    assert r.capacity == c
    np.testing.assert_array_equal(r.gate_idx.numpy(), np.asarray(gate_idx))
    np.testing.assert_array_equal(r.keep.numpy(), np.asarray(keep))
    np.testing.assert_array_equal(r.pos.numpy(), np.asarray(pos))
    _close(r.probs, probs, SAME_ALGO_TOL)
    _close(r.gate_vals, gate_vals, SAME_ALGO_TOL)
    dropped = int((~r.keep).sum())
    if case.endswith("drops"):
        assert dropped > 0
    elif b * s <= M.DROPLESS_MAX_GROUP:
        assert dropped == 0
    if zeros:   # every probability 1/E: the lowest experts, in order
        assert (r.gate_idx == torch.arange(cfg.top_k)).all()

    want_y, want_aux = jax.jit(functools.partial(JM.moe_ffn, cfg))(params, jnp.asarray(x))
    got_y, got_aux = M.moe_ffn(mine, {k: _t(v) for k, v in params.items()}, _t(x))
    _close(got_y, want_y, SAME_ALGO_TOL, rel_to_max=True)
    _close(got_aux, want_aux, SAME_ALGO_TOL)


def test_top_k_keeps_lax_order_among_ties():
    """Values drawn from 3 levels: most rows tie; indices and values equal."""
    rng = np.random.default_rng(0)
    for e, k in [(4, 2), (16, 8), (384, 8)]:
        probs = rng.integers(0, 3, (64, e)).astype(np.float32) / 4
        want_v, want_i = jax.lax.top_k(jnp.asarray(probs), k)
        got_v, got_i = M.top_k(_t(probs), k)
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
        np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))


@pytest.mark.parametrize("arch", ARCHS + ["jamba-v0.1-52b"])
def test_capacity_and_init_layout_match_reference(arch):
    """``_capacity`` over group sizes; ``init_moe``'s names, shapes and
    dtypes in bf16 (the router float32) against the reference's."""
    cfg = RC.get(arch)
    for cf in (0.5, 1.0, 1.25, 2.0):
        c = dataclasses.replace(cfg, capacity_factor=cf)
        for g in (1, 4, 255, 256, 257, 600, 1000, 1024):
            assert M._capacity(_mine(c), g) == JM._capacity(c, g)
    small = dataclasses.replace(cfg.reduced(), dtype="bfloat16")
    want = jax.eval_shape(lambda k: JM.init_moe(k, small)[0], jax.random.PRNGKey(0))
    got = M.init_moe(torch.Generator().manual_seed(0), _mine(small))
    assert set(got) == set(want)
    for name, leaf in want.items():
        assert tuple(got[name].shape) == leaf.shape, name
        assert str(got[name].dtype).split(".")[-1] == str(leaf.dtype), name
    assert got["router"].dtype == torch.float32


@pytest.mark.parametrize("arch", ARCHS + ["jamba-v0.1-52b"])
def test_build_takes_the_full_configs(arch):
    model = T.build(C.get(arch))
    ref = JT.build(RC.get(arch))
    assert (model.prefix, model.pattern, model.n_rep) == (ref.prefix, ref.pattern, ref.n_rep)
    assert T.layer_plans(model) == list(model.prefix) + [
        p for p in model.pattern for _ in range(model.n_rep)]


# ---------------------------------------------------------------------------
# Whole models at reduced()
# ---------------------------------------------------------------------------


def _ref_init(jmodel, seed):
    """The reference's ``init_params`` under ``jit`` (eager, each op is
    compiled on its own; the values are the reference's either way)."""
    return jax.jit(lambda k: JT.init_params(jmodel, k)[0])(jax.random.PRNGKey(seed))


@functools.lru_cache(maxsize=None)
def _models(arch):
    cfg = RC.get(arch).reduced()
    jmodel = JT.build(cfg)
    jparams = _ref_init(jmodel, 0)
    mine = C.get(arch).reduced()
    tparams = convert.model_params(mine, jax.tree.map(np.asarray, jparams), device="cpu")
    return cfg, jmodel, jparams, mine, T.build(mine), tparams


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, s)).astype(np.int32)


def test_model_params_carries_moe_trees():
    """A bf16 Kimi K2 tree arrives bit for bit, the router float32, the
    dense prefix layer first and the MoE layer after it."""
    cfg = dataclasses.replace(RC.get("kimi-k2-1t-a32b").reduced(), dtype="bfloat16")
    ref = jax.tree.map(np.asarray, _ref_init(JT.build(cfg), 4))
    got = convert.model_params(_mine(cfg), ref, device="cpu")
    dense, moe = got["layers"]
    assert set(dense["ffn"]) == {"w_gate", "w_up", "w_down"}
    assert moe["ffn"]["router"].dtype == torch.float32
    assert moe["ffn"]["w_gate"].dtype == torch.bfloat16
    for name, want in ref["pattern"][0]["ffn"].items():
        np.testing.assert_array_equal(moe["ffn"][name].to(torch.float32).numpy(),
                                      np.asarray(want[0], np.float32))
    np.testing.assert_array_equal(dense["ffn"]["w_up"].to(torch.float32).numpy(),
                                  np.asarray(ref["prefix"][0]["ffn"]["w_up"], np.float32))


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_aux_and_prefill_match_reference(arch):
    cfg, jmodel, jparams, mine, tmodel, tparams = _models(arch)
    toks = _tokens(cfg, 2, 72, 1)
    want, want_aux = jax.jit(functools.partial(JT.forward, jmodel))(
        jparams, {"tokens": jnp.asarray(toks)})
    got, got_aux = T.forward(tmodel, tparams, {"tokens": torch.as_tensor(toks).long()},
                             return_aux=True)
    _close(got, want, MODEL_TOL, rel_to_max=True)
    _close(got_aux, want_aux, MODEL_TOL)
    assert float(got_aux) > 0
    torch.testing.assert_close(
        T.forward(tmodel, tparams, {"tokens": torch.as_tensor(toks).long()}), got,
        rtol=0, atol=0)
    want = jax.jit(functools.partial(JT.prefill_step, jmodel))(
        jparams, {"tokens": jnp.asarray(toks)})
    got = T.prefill_step(tmodel, tparams, {"tokens": torch.as_tensor(toks).long()})
    _close(got, want, MODEL_TOL, rel_to_max=True)


def _ref_layer_caches(jmodel, cache):
    out = list(cache["prefix"])
    for stacked in cache["pattern"]:
        out += [jax.tree.map(lambda a, r=r: a[r], stacked) for r in range(jmodel.n_rep)]
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_steps_match_reference(arch):
    """Eight decode steps (each MoE call one dropless group of 2 tokens):
    logits and every layer's KV cache."""
    cfg, jmodel, jparams, mine, tmodel, tparams = _models(arch)
    step = jax.jit(functools.partial(JT.serve_step, jmodel))
    jcache = JT.init_cache(jmodel, 2, 16)
    tcache = T.init_cache(tmodel, 2, 16, device="cpu")
    toks = _tokens(cfg, 2, 8, 2)
    for pos in range(8):
        want, jcache = step(jparams, jcache, jnp.asarray(toks[:, pos:pos + 1]),
                            jnp.int32(pos))
        got, tcache = T.serve_step(tmodel, tparams, tcache,
                                   torch.as_tensor(toks[:, pos:pos + 1]).long(), pos)
        _close(got, want, MODEL_TOL, rel_to_max=True)
    for mine_c, ref_c in zip(tcache, _ref_layer_caches(jmodel, jcache)):
        for a, b in zip(mine_c, jax.tree.leaves(ref_c)):
            _close(a, b, MODEL_TOL, rel_to_max=True)


def _requests(cfg, cls, temperature):
    """tests/test_serve.py's three requests."""
    rng = np.random.default_rng(0)
    return [cls(prompt=rng.integers(0, cfg.vocab, size=n), max_new_tokens=m,
                temperature=temperature) for n, m in ((5, 4), (8, 6), (3, 4))]


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_gives_the_reference_tokens(arch, monkeypatch):
    """Greedy and at temperature 0.8.  The reference's server is handed the
    cached reference weights in place of its own ``init_params`` draw."""
    cfg, jmodel, jparams, mine, tmodel, tparams = _models(arch)
    monkeypatch.setattr(JT, "init_params", lambda model, key: (jparams, None))
    jserver = JServer(cfg, max_batch=3, max_seq=64)
    server = Server(mine, max_batch=3, max_seq=64, device="cpu")
    server.load_params(tparams)
    for temperature in (0.0, 0.8):
        want = jserver.generate(_requests(cfg, JRequest, temperature))
        got = server.generate(_requests(mine, Request, temperature))
        assert [len(o) for o in got] == [4, 6, 4]
        for g, w in zip(got, want):
            assert g.dtype == np.int32
            np.testing.assert_array_equal(g, w)
