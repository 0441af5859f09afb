"""The port's Mamba mixer (``repro_torch.models.mamba``) and Jamba (Mamba and
attention 7:1, MoE every second layer) against the JAX reference on the CPU.

Inputs are made with numpy from a seed and handed to both packages; the
reference's weights are carried into the port by ``convert.model_params``.
The reference's Jamba (one unit of 8 layers at ``reduced()``) is built once
per file: its ``init_params`` is the slowest step here.
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
from repro.models import mamba as JMa
from repro.models import transformer as JT

import repro_torch.configs as C
from repro_torch import convert
from repro_torch.launch.serve import Request, Server
from repro_torch.models import mamba as Ma
from repro_torch.models import transformer as T
from repro_torch.models.config import ArchConfig

ARCH = "jamba-v0.1-52b"
# The Mamba block in f32 in both packages: the projections' summation order
# and the libraries' exp, log1p and sigmoid differ by a few ulp, carried
# through the recurrence over up to 72 tokens; relative to the largest entry.
MAMBA_TOL = 1e-5
# Logits of the 8-layer unit, relative to their largest entry.
MODEL_TOL = 1e-4


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


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


# ---------------------------------------------------------------------------
# The Mamba block
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _mamba():
    cfg = RC.get(ARCH).reduced()
    p, _ = JMa.init_mamba(jax.random.PRNGKey(5), cfg)
    # The init's zero conv bias exercises little: perturb it.
    p = dict(p, conv_b=0.1 * jnp.asarray(_x((cfg.d_inner,), 6)))
    return cfg, p, {k: _t(v) for k, v in p.items()}


def _state(cfg, b, seed):
    """Zeros (seed None) or a nonzero state, as (reference, port) pairs."""
    if seed is None:
        st = JMa.init_mamba_state(cfg, b)
    else:
        st = JMa.MambaState(conv=jnp.asarray(_x((b, cfg.mamba_d_conv - 1, cfg.d_inner), seed)),
                            ssm=0.1 * jnp.asarray(_x((b, cfg.d_inner, cfg.mamba_d_state),
                                                     seed + 1)))
    return st, Ma.MambaState(*(_t(a) for a in st))


@pytest.mark.parametrize("seed", [None, 7])
@pytest.mark.parametrize("s", [1, 2, 72])
def test_mamba_block_matches_reference(s, seed):
    """S < d_conv - 1 takes the conv state's concatenation branch."""
    cfg, p, tp = _mamba()
    jst, tst = _state(cfg, 2, seed)
    x = 0.5 * _x((2, s, cfg.d_model), s)
    want, wst = jax.jit(functools.partial(JMa.mamba_block, cfg))(p, jnp.asarray(x), jst)
    got, gst = Ma.mamba_block(_mine(cfg), tp, _t(x), tst)
    _close(got, want, MAMBA_TOL, rel_to_max=True)
    assert isinstance(gst, Ma.MambaState) and gst._fields == ("conv", "ssm")
    for a, b in zip(gst, wst):
        _close(a, b, MAMBA_TOL, rel_to_max=True)


@pytest.mark.parametrize("seed", [None, 7])
def test_mamba_decode_steps_match_reference_and_prefill(seed):
    """Six decode steps against the reference's, state leaves included; the
    port's steps against its own ``mamba_block`` over the same tokens."""
    cfg, p, tp = _mamba()
    mine = _mine(cfg)
    jst, tst = _state(cfg, 2, seed)
    x = 0.5 * _x((2, 6, cfg.d_model), 9)
    step = jax.jit(functools.partial(JMa.decode_step, cfg))
    outs, st0 = [], tst
    for t in range(6):
        want, jst = step(p, jnp.asarray(x[:, t:t + 1]), jst)
        got, tst = Ma.decode_step(mine, tp, _t(x[:, t:t + 1]), tst)
        _close(got, want, MAMBA_TOL, rel_to_max=True)
        for a, b in zip(tst, jst):
            _close(a, b, MAMBA_TOL, rel_to_max=True)
        outs.append(got)
    pre, pst = Ma.mamba_block(mine, tp, _t(x), st0)
    _close(torch.cat(outs, 1), pre.numpy(), MAMBA_TOL, rel_to_max=True)
    for a, b in zip(tst, pst):
        _close(a, b.numpy(), MAMBA_TOL, rel_to_max=True)


def test_softplus_and_init_layout_match_reference():
    """``softplus`` is jax's (logaddexp(x, 0)) within a float32 ulp or two;
    ``init_mamba``'s names, shapes and dtypes in bf16 are the reference's,
    ``dt_proj_b``, ``A_log`` and ``D`` float32."""
    x = np.linspace(-30, 30, 20001, dtype=np.float32)
    _close(Ma.softplus(_t(x)), jax.nn.softplus(jnp.asarray(x)), 3e-7)
    cfg = dataclasses.replace(RC.get(ARCH).reduced(), dtype="bfloat16")
    want = jax.eval_shape(lambda k: JMa.init_mamba(k, cfg)[0], jax.random.PRNGKey(0))
    got = Ma.init_mamba(torch.Generator().manual_seed(0), _mine(cfg))
    assert set(got) == set(want)
    for name, leaf in want.items():
        assert tuple(got[name].shape) == leaf.shape, name
        assert str(got[name].dtype).split(".")[-1] == str(leaf.dtype), name
    for name in ("dt_proj_b", "A_log", "D"):
        assert got[name].dtype == torch.float32
    st = Ma.init_mamba_state(_mine(cfg), 3, torch.bfloat16, "cpu")
    ref = JMa.init_mamba_state(cfg, 3, jnp.bfloat16)
    assert [(tuple(a.shape), str(a.dtype).split(".")[-1]) for a in st] == \
        [(a.shape, str(a.dtype)) for a in ref]


# ---------------------------------------------------------------------------
# Jamba at reduced(): one unit of 8 layers
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _models():
    """Reference model and weights (``init_params`` under ``jit``: eager,
    each op compiles on its own), and the port's with the same weights."""
    cfg = RC.get(ARCH).reduced()
    jmodel = JT.build(cfg)
    jparams = jax.jit(lambda k: JT.init_params(jmodel, k)[0])(jax.random.PRNGKey(0))
    mine = C.get(ARCH).reduced()
    tparams = convert.model_params(mine, jax.tree.map(np.asarray, jparams), device="cpu")
    return cfg, jmodel, jparams, mine, T.build(mine), tparams


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, s)).astype(np.int32)


def test_model_params_unit_layout():
    """Eight layers in the reference's order (Mamba everywhere but position
    4, MoE at the odd positions), float32 leaves kept float32."""
    cfg, jmodel, jparams, mine, tmodel, tparams = _models()
    plans = T.layer_plans(tmodel)
    assert plans == [cfg.layer_plan(i) for i in range(8)]
    assert [p[0] for p in plans].count("attn") == 1
    for plan, layer in zip(plans, tparams["layers"]):
        assert ("router" in layer["ffn"]) == (plan[1] == "moe")
        if plan[0] == "mamba":
            assert layer["mixer"]["A_log"].dtype == torch.float32
            assert "w_gate" not in layer["mixer"]
    np.testing.assert_array_equal(tparams["layers"][3]["ffn"]["w_down"].numpy(),
                                  np.asarray(jparams["pattern"][3]["ffn"]["w_down"][0]))


def test_forward_aux_and_prefill_match_reference():
    cfg, jmodel, jparams, mine, tmodel, tparams = _models()
    toks = _tokens(cfg, 2, 72, 1)
    want, want_aux = jax.jit(functools.partial(JT.forward, jmodel))(
        jparams, {"tokens": jnp.asarray(toks)})
    got, got_aux = T.forward(tmodel, tparams, {"tokens": torch.as_tensor(toks).long()},
                             return_aux=True)
    _close(got, want, MODEL_TOL, rel_to_max=True)
    _close(got_aux, want_aux, MODEL_TOL)
    _close(T.prefill_step(tmodel, tparams, {"tokens": torch.as_tensor(toks).long()}),
           np.asarray(want)[:, -1:], MODEL_TOL, rel_to_max=True)


def _ref_layer_caches(jmodel, cache):
    out = list(cache["prefix"])
    for stacked in cache["pattern"]:
        out += [jax.tree.map(lambda a, r=r: a[r], stacked) for r in range(jmodel.n_rep)]
    return out


def test_serve_steps_match_reference_and_prefill():
    """Eight decode steps: logits and every layer's KV or Mamba cache
    against the reference; the last step's logits against the port's own
    prefill of the same 8 tokens (B * S = 16: dropless in both)."""
    cfg, jmodel, jparams, mine, tmodel, tparams = _models()
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
    assert sum(isinstance(c, Ma.MambaState) for c in tcache) == 7
    for mine_c, ref_c in zip(tcache, _ref_layer_caches(jmodel, jcache)):
        for a, b in zip(mine_c, jax.tree.leaves(ref_c)):
            _close(a, b, MODEL_TOL, rel_to_max=True)
    pre = T.prefill_step(tmodel, tparams, {"tokens": torch.as_tensor(toks).long()})
    _close(pre, got.numpy(), MODEL_TOL, rel_to_max=True)
    assert torch.equal(pre.argmax(-1), got.argmax(-1))


def _requests(cfg, cls, temperature):
    """tests/test_serve.py's three requests."""
    rng = np.random.default_rng(0)
    return [cls(prompt=rng.integers(0, cfg.vocab, size=n), max_new_tokens=m,
                temperature=temperature) for n, m in ((5, 4), (8, 6), (3, 4))]


def test_generate_gives_the_reference_tokens(monkeypatch):
    """Greedy and at temperature 0.8.  The reference's server is handed the
    cached reference weights in place of its own ``init_params`` draw."""
    cfg, jmodel, jparams, mine, tmodel, tparams = _models()
    monkeypatch.setattr(JT, "init_params", lambda model, key: (jparams, None))
    jserver = JServer(cfg, max_batch=3, max_seq=64)
    server = Server(mine, max_batch=3, max_seq=64, device="cpu")
    server.load_params(tparams)
    for temperature in (0.0, 0.8):
        want = jserver.generate(_requests(cfg, JRequest, temperature))
        got = server.generate(_requests(mine, Request, temperature))
        assert [len(o) for o in got] == [4, 6, 4]
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def test_prefill_matches_decode_in_one_dropless_group():
    """The port's Jamba, prefill of (2, 128) (one group of 256 tokens:
    dropless) against 128 teacher-forced decode steps: equal argmax."""
    cfg, jmodel, jparams, mine, tmodel, tparams = _models()
    toks = torch.as_tensor(_tokens(cfg, 2, 128, 3)).long()
    pre = T.prefill_step(tmodel, tparams, {"tokens": toks})
    cache = T.init_cache(tmodel, 2, 128, device="cpu")
    for t in range(128):
        dec, cache = T.serve_step(tmodel, tparams, cache, toks[:, t:t + 1], t)
    _close(pre, dec.numpy(), MODEL_TOL, rel_to_max=True)
    assert torch.equal(pre.argmax(-1), dec.argmax(-1))
