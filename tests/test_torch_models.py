"""The port's model substrate (``repro_torch.models``, ``configs``,
``launch.serve``) against the JAX reference on the CPU.

Inputs are made with numpy from a seed and handed to both packages; the
reference's weights are carried into the port by ``convert.model_params``.
The reference's Pallas kernels run in interpret mode, as its own tests run
them.  Every tolerance is stated where it is used, with its reason.
"""
import dataclasses
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as RC
from repro.kernels import ops as jops
from repro.launch.serve import Request as JRequest
from repro.launch.serve import Server as JServer
from repro.models import layers as JL
from repro.models import rwkv6 as JR
from repro.models import transformer as JT

import repro_torch.configs as C
from repro_torch import convert, prng
from repro_torch.kernels import flash_attn as fa
from repro_torch.kernels import ops
from repro_torch.kernels import rwkv_chunk as rc
from repro_torch.launch.serve import Request, Server
from repro_torch.models import layers as L
from repro_torch.models.config import ArchConfig
from repro_torch.models import rwkv6 as R
from repro_torch.models import transformer as T

# The plain versions against the Pallas kernels in interpret mode: the
# reference tests' own bounds (tests/test_flash_attn.py, test_rwkv_kernel.py).
FLASH_TOL = {np.float32: 2e-4, "bfloat16": 2e-2}
RWKV_TOL = 3e-4
# Same algorithm in both packages, f32 throughout: only the summation order
# of the matmuls differs (a few ulp of O(1) values).
SAME_ALGO_TOL = 1e-5


def _t(x, dtype=None):
    """numpy / jax array -> CPU tensor with the same values."""
    out = torch.from_numpy(np.array(np.asarray(x, np.float32)))
    return out if dtype is None else out.to(dtype)


def _tree_t(tree):
    return jax.tree.map(lambda a: _t(a), tree)


def _close(got, want, tol, rel_to_max=False):
    got = got.detach().to(torch.float32).numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    atol = tol * max(1.0, float(np.abs(want).max())) if rel_to_max else tol
    np.testing.assert_allclose(got, want, rtol=tol, atol=atol)


# ---------------------------------------------------------------------------
# Kernels' plain versions
# ---------------------------------------------------------------------------

FLASH_SHAPES = [   # tests/test_flash_attn.py's SHAPES
    dict(b=1, sq=128, skv=128, h=2, hkv=2, dh=128),
    dict(b=2, sq=64, skv=96, h=4, hkv=2, dh=32),
    dict(b=1, sq=130, skv=257, h=2, hkv=1, dh=64),
    dict(b=2, sq=32, skv=512, h=8, hkv=8, dh=128),
]


def _qkv(b=2, sq=64, skv=64, h=4, hkv=2, dh=32, seed=21):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, sq, h, dh), np.float32)
    k = rng.standard_normal((b, skv, hkv, dh), np.float32)
    v = rng.standard_normal((b, skv, hkv, dh), np.float32)
    return q, k, v


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", FLASH_SHAPES)
def test_flash_plain_matches_pallas(shape, causal):
    q, k, v = _qkv(**shape)
    scale = shape["dh"] ** -0.5
    want = jops.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                causal=causal, scale=scale)
    got = ops.flash_attention(_t(q), _t(k), _t(v), causal=causal, scale=scale)
    _close(got, want, FLASH_TOL[np.float32])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_plain_dtypes(dtype):
    q, k, v = _qkv(dh=64)
    jd = jnp.float32 if dtype == "float32" else jnp.bfloat16
    td = torch.float32 if dtype == "float32" else torch.bfloat16
    want = jops.flash_attention(*(jnp.asarray(a, jd) for a in (q, k, v)), causal=True,
                                scale=0.125)
    # bf16 inputs: both sides round the same bf16 values' products in f32.
    qb, kb, vb = (_t(np.asarray(jnp.asarray(a, jd), np.float32), td) for a in (q, k, v))
    got = ops.flash_attention(qb, kb, vb, causal=True, scale=0.125)
    assert got.dtype == td
    tol = FLASH_TOL[np.float32] if dtype == "float32" else FLASH_TOL["bfloat16"]
    _close(got, want, tol)


@pytest.mark.parametrize("causal,window", [(True, 16), (False, 16), (True, 100)])
def test_flash_plain_sliding_window(causal, window):
    q, k, v = _qkv(sq=128, skv=128, dh=32)
    want = jops.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                causal=causal, window=window, scale=0.1)
    got = ops.flash_attention(_t(q), _t(k), _t(v), causal=causal, window=window, scale=0.1)
    _close(got, want, FLASH_TOL[np.float32])


@pytest.mark.parametrize("causal,window,q_offset,kv_chunk,sq,skv", [
    (True, 0, 0, 16, 64, 64), (True, 8, 0, 16, 64, 64), (False, 0, 0, 32, 64, 100),
    (True, 0, 36, 16, 28, 64), (True, 0, 0, 1024, 100, 100)])
def test_chunk_attn_scan_matches_reference(causal, window, q_offset, kv_chunk, sq, skv):
    q, k, v = _qkv(sq=sq, skv=skv)
    kw = dict(causal=causal, window=window, q_offset=q_offset, kv_chunk=kv_chunk,
              scale=32 ** -0.5)
    want = JL._chunk_attn_scan(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw)
    _close(fa.chunk_attn_scan(_t(q), _t(k), _t(v), **kw), want, SAME_ALGO_TOL)


def _streams(b=2, s=128, h=2, dh=64, seed=31, strong=False):
    rng = np.random.default_rng(seed + s)
    r, k, v = (rng.standard_normal((b, s, h, dh), np.float32) for _ in range(3))
    logw = -np.exp(rng.standard_normal((b, s, h, dh)).astype(np.float32) - 2.0)
    if strong:
        logw = np.full_like(logw, -15.0)
    u = (0.1 * rng.standard_normal((h, dh))).astype(np.float32)
    return r, k, v, logw, u


@pytest.mark.parametrize("strong", [False, True])
@pytest.mark.parametrize("s", [64, 128, 100])
def test_rwkv_plain_matches_pallas_and_sequential(s, strong):
    r, k, v, logw, u = _streams(s=s, strong=strong)
    j = [jnp.asarray(a) for a in (r, k, v, logw, u)]
    want_kernel = jops.rwkv_time_mix(*j)
    want_seq, _ = JR._time_mix_sequential(*j, jnp.zeros((2, 2, 64, 64)))
    got = ops.rwkv_time_mix(*(_t(a) for a in (r, k, v, logw, u)))
    assert bool(torch.isfinite(got).all())
    _close(got, want_kernel, RWKV_TOL)
    _close(got, want_seq, RWKV_TOL)


@pytest.mark.parametrize("chunk", [0, 16, 64])
def test_rwkv_forms_with_state_match_reference(chunk):
    """Both plain forms from a nonzero state, with their final states."""
    r, k, v, logw, u = _streams(s=100)
    s0 = 0.1 * np.random.default_rng(5).standard_normal((2, 2, 64, 64)).astype(np.float32)
    j = [jnp.asarray(a) for a in (r, k, v, logw, u, s0)]
    t = [_t(a) for a in (r, k, v, logw, u, s0)]
    if chunk:
        want, want_s = JR._time_mix_chunked(*j, chunk=chunk)
        got, got_s = R._time_mix_chunked(*t, chunk=chunk)
    else:
        want, want_s = JR._time_mix_sequential(*j)
        got, got_s = R._time_mix_sequential(*t)
    # |o| reaches ~100 here: relative to the largest entry, f32 sums in
    # another order (the two forms differ by ~7e-7 of the largest |o|).
    _close(got, want, SAME_ALGO_TOL, rel_to_max=True)
    _close(got_s, want_s, SAME_ALGO_TOL, rel_to_max=True)


def test_categorical_matches_jax():
    rng = np.random.default_rng(2)
    logits = (3 * rng.standard_normal((6, 500))).astype(np.float32)
    for seed in range(4):
        key = jax.random.fold_in(jax.random.PRNGKey(seed), 7)
        want = np.asarray(jax.random.categorical(key, jnp.asarray(logits), axis=-1))
        got = prng.categorical(prng.fold_in(prng.PRNGKey(seed, device="cpu"), 7),
                               _t(logits))
        np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# Configs and build
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", RC.ARCH_IDS)
def test_configs_are_the_reference(arch):
    mine, ref = C.get(arch), RC.get(arch)
    assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
    assert dataclasses.asdict(mine.reduced()) == dataclasses.asdict(ref.reduced())
    assert mine.params_count() == ref.params_count()
    assert [mine.layer_plan(i) for i in range(mine.n_layers)] == \
        [ref.layer_plan(i) for i in range(ref.n_layers)]
    for shape in C.SHAPES:
        assert C.shape_supported(mine, shape) == RC.shape_supported(ref, shape)
        assert dataclasses.asdict(C.for_shape(mine, shape)) == \
            dataclasses.asdict(RC.for_shape(ref, shape))
    assert C.ALIASES == RC.ALIASES and C.SHAPES == RC.SHAPES


@pytest.mark.parametrize("arch", list(C.all_configs()))
def test_build_accepts_every_config(arch):
    """Every config the repo ships, as the reference's ``plan_groups``
    factors it; ``layer_plans`` runs the prefix, then each pattern
    position's repetitions."""
    mine = C.all_configs()[arch]
    assert dataclasses.asdict(mine) == dataclasses.asdict(RC.all_configs()[arch])
    model, ref = T.build(mine), JT.build(RC.get(arch))
    assert (model.prefix, model.pattern, model.n_rep) == JT.plan_groups(RC.get(arch))
    assert (model.prefix, model.pattern, model.n_rep) == (ref.prefix, ref.pattern, ref.n_rep)
    assert T.layer_plans(model) == list(ref.prefix) + [
        p for p in ref.pattern for _ in range(ref.n_rep)]
    assert len(T.layer_plans(model)) == mine.n_layers
    T.build(dataclasses.replace(mine, kv_cache_quant=True))


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def test_rmsnorm_and_rope_match_reference():
    x = _x((2, 10, 4, 32))
    scale = 0.1 * _x((32,), 1)
    _close(L.rmsnorm(_t(x), _t(scale)), JL.rmsnorm(jnp.asarray(x), jnp.asarray(scale)),
           SAME_ALGO_TOL)
    pos = np.arange(10)[None] + np.array([[0], [17]])
    for theta in (1e4, 1e6):
        _close(L.apply_rope(_t(x), torch.as_tensor(pos), theta),
               JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta), SAME_ALGO_TOL)


def _qwen(**kw):
    return dataclasses.replace(RC.get("qwen3-1.7b").reduced(), **kw)


def _mine(cfg):
    """The port's ``ArchConfig`` with the reference config's fields."""
    return ArchConfig(**dataclasses.asdict(cfg))


@pytest.mark.parametrize("window", [0, 8])
def test_attention_and_ffn_match_reference(window):
    cfg = _qwen(sliding_window=window)
    p, _ = JL.init_attn(jax.random.PRNGKey(1), cfg)
    f, _ = JL.init_ffn(jax.random.PRNGKey(2), cfg)
    p = dict(p, q_norm=0.1 * jnp.asarray(_x((32,), 3)), k_norm=0.1 * jnp.asarray(_x((32,), 4)))
    x = 0.5 * _x((2, 40, cfg.d_model), 5)
    pos = jnp.arange(40)[None]
    want = JL.attention(cfg, p, jnp.asarray(x), pos)
    got = L.attention(_mine(cfg), _tree_t(p), _t(x), torch.arange(40)[None])
    _close(got, want, SAME_ALGO_TOL)
    _close(L.ffn(_tree_t(f), _t(x)), JL.ffn(f, jnp.asarray(x)), SAME_ALGO_TOL)


@pytest.mark.parametrize("window", [0, 8])
def test_decode_attention_matches_reference(window):
    """12 decode steps; with window 8 the cache is an 8-slot ring buffer."""
    cfg = _qwen(sliding_window=window)
    p, _ = JL.init_attn(jax.random.PRNGKey(1), cfg)
    entry = JT.init_cache_entry(cfg, ("attn", "dense"), 2, 16)
    mine = T.init_cache_entry(_mine(cfg), ("attn", "dense"), 2, 16, device="cpu")
    assert mine[0].shape == entry[0].shape == (2, 8 if window else 16, 2, 32)
    jcache, tcache = entry, mine
    tp = _tree_t(p)
    for pos in range(12):
        x = 0.5 * _x((2, 1, cfg.d_model), 10 + pos)
        want, jcache = JL.decode_attention(cfg, p, jnp.asarray(x), jnp.int32(pos), jcache)
        got, tcache = L.decode_attention(_mine(cfg), tp, _t(x), pos, tcache)
        _close(got, want, SAME_ALGO_TOL)
        for a, b in zip(tcache, jcache):
            _close(a, b, SAME_ALGO_TOL)


# ---------------------------------------------------------------------------
# RWKV-6 block
# ---------------------------------------------------------------------------


def _rwkv_setup():
    cfg = RC.get("rwkv6-1.6b").reduced()
    p, _ = JR.init_rwkv(jax.random.PRNGKey(3), cfg)
    # The init's zeros and constants exercise little: perturb the norm and
    # the decay LoRA.  decay_w2 at 0.3 gives per-token decays of ~0.003-0.4;
    # much larger weights make |c_t| reach 1e4 within a chunk, where both
    # packages' closed forms lose digits to the exponent of a difference of
    # two such sums.
    p = dict(p, ln_x=0.1 * jnp.asarray(_x((cfg.d_model,), 6)),
             decay_w2=0.3 * jnp.asarray(_x((64, cfg.d_model), 7)))
    return cfg, p


def _state(cfg, seed):
    h = cfg.d_model // 64
    return JR.RWKVState(s=0.1 * jnp.asarray(_x((2, h, 64, 64), seed)),
                        x_prev_tm=jnp.asarray(_x((2, cfg.d_model), seed + 1)),
                        x_prev_cm=jnp.asarray(_x((2, cfg.d_model), seed + 2)))


def _tstate(st):
    return R.RWKVState(*(_t(a) for a in st))


@pytest.mark.parametrize("chunk", [0, 16])
def test_rwkv_time_and_channel_mix_match_reference(chunk):
    cfg, p = _rwkv_setup()
    mine, tp = _mine(cfg), _tree_t(p)
    x = _x((2, 70, cfg.d_model), 8)
    st = _state(cfg, 20)
    want, wst = JR.time_mix_chunk(cfg, p, jnp.asarray(x), st, chunk=chunk)
    got, gst = R.time_mix_chunk(mine, tp, _t(x), _tstate(st), chunk=chunk)
    _close(got, want, SAME_ALGO_TOL, rel_to_max=True)
    for a, b in zip(gst, wst):
        _close(a, b, SAME_ALGO_TOL, rel_to_max=True)
    want, wst = JR.channel_mix(cfg, p, jnp.asarray(x), st)
    got, gst = R.channel_mix(mine, tp, _t(x), _tstate(st))
    _close(got, want, SAME_ALGO_TOL, rel_to_max=True)
    _close(gst.x_prev_cm, wst.x_prev_cm, 0.0)


def test_rwkv_prefill_mix_matches_reference():
    """The kernel route's plain version (chunked, zero state) against the
    reference's per-token form, as ``apply_layer`` runs each."""
    cfg, p = _rwkv_setup()
    x = _x((2, 100, cfg.d_model), 9)
    st0 = JR.init_rwkv_state(cfg, 2)
    want, _ = JR.time_mix_chunk(cfg, p, jnp.asarray(x), st0)
    got = R.time_mix_prefill(_mine(cfg), _tree_t(p), _t(x))
    _close(got, want, RWKV_TOL)


def test_rwkv_decode_steps_match_reference():
    cfg, p = _rwkv_setup()
    mine, tp = _mine(cfg), _tree_t(p)
    jst = _state(cfg, 30)
    tst = _tstate(jst)
    for i in range(6):
        x = _x((2, 1, cfg.d_model), 40 + i)
        want, jst = JR.decode_step(cfg, p, jnp.asarray(x), jst)
        got, tst = R.decode_step(mine, tp, _t(x), tst)
        _close(got, want, SAME_ALGO_TOL, rel_to_max=True)
        want, jst = JR.decode_channel_mix(cfg, p, jnp.asarray(x), jst)
        got, tst = R.decode_channel_mix(mine, tp, _t(x), tst)
        _close(got, want, SAME_ALGO_TOL, rel_to_max=True)
        for a, b in zip(tst, jst):
            _close(a, b, SAME_ALGO_TOL, rel_to_max=True)


# ---------------------------------------------------------------------------
# Whole models
# ---------------------------------------------------------------------------

ARCHS = ["qwen3-1.7b", "minitron-8b", "rwkv6-1.6b"]
# Logits of a 2-layer model, relative to their largest entry: f32 matmuls
# in another order, and for RWKV-6 the chunked mix against the reference's
# per-token recurrence (~1e-6 relative at these sizes).
MODEL_TOL = 1e-4


@functools.lru_cache(maxsize=None)
def _models(arch):
    cfg = RC.get(arch).reduced()
    jmodel = JT.build(cfg)
    jparams, _ = JT.init_params(jmodel, jax.random.PRNGKey(0))
    mine = C.get(arch).reduced()
    tparams = convert.model_params(mine, jax.tree.map(np.asarray, jparams), device="cpu")
    return cfg, jmodel, jparams, mine, T.build(mine), tparams


def test_model_params_carries_bf16_values():
    """A bf16 reference tree arrives bit for bit, unstacked in layer order."""
    cfg = dataclasses.replace(RC.get("rwkv6-1.6b").reduced(), dtype="bfloat16")
    jparams, _ = JT.init_params(JT.build(cfg), jax.random.PRNGKey(4))
    ref = jax.tree.map(np.asarray, jparams)
    got = convert.model_params(ArchConfig(**dataclasses.asdict(cfg)), ref, device="cpu")
    assert got["embed"].dtype == torch.bfloat16 and len(got["layers"]) == 2
    for r, layer in enumerate(got["layers"]):
        for name in ("w_r", "bonus_u", "decay_bias"):
            want = np.asarray(ref["pattern"][0]["mixer"][name][r], np.float32)
            np.testing.assert_array_equal(layer["mixer"][name].to(torch.float32).numpy(), want)
    np.testing.assert_array_equal(got["head"].to(torch.float32).numpy(),
                                  np.asarray(ref["head"], np.float32))


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, s)).astype(np.int32)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_prefill_match_reference(arch):
    cfg, jmodel, jparams, mine, tmodel, tparams = _models(arch)
    toks = _tokens(cfg, 2, 72, 1)
    want, _ = JT.forward(jmodel, jparams, {"tokens": jnp.asarray(toks)})
    got = T.forward(tmodel, tparams, {"tokens": torch.as_tensor(toks).long()})
    _close(got, want, MODEL_TOL, rel_to_max=True)
    want = JT.prefill_step(jmodel, jparams, {"tokens": jnp.asarray(toks)})
    got = T.prefill_step(tmodel, tparams, {"tokens": torch.as_tensor(toks).long()})
    _close(got, want, MODEL_TOL, rel_to_max=True)


def _ref_layer_caches(jmodel, cache):
    """The reference's cache as a list in ``layer_plans`` order."""
    out = list(cache["prefix"])
    for stacked in cache["pattern"]:
        out += [jax.tree.map(lambda a, r=r: a[r], stacked) for r in range(jmodel.n_rep)]
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_steps_match_reference(arch):
    """Eight decode steps: logits and every layer's cache."""
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
    return [cls(prompt=rng.integers(0, cfg.vocab, size=5), max_new_tokens=4,
                temperature=temperature),
            cls(prompt=rng.integers(0, cfg.vocab, size=8), max_new_tokens=6,
                temperature=temperature),
            cls(prompt=rng.integers(0, cfg.vocab, size=3), max_new_tokens=4,
                temperature=temperature)]


@pytest.mark.parametrize("temperature", [0.0, 0.8])
@pytest.mark.parametrize("arch", ["qwen3-1.7b", "rwkv6-1.6b"])
def test_generate_gives_the_reference_tokens(arch, temperature):
    cfg = RC.get(arch).reduced()
    jserver = JServer(cfg, max_batch=3, max_seq=64)
    want = jserver.generate(_requests(cfg, JRequest, temperature))
    mine = C.get(arch).reduced()
    server = Server(mine, max_batch=3, max_seq=64, device="cpu")
    server.load_params(convert.model_params(
        mine, jax.tree.map(np.asarray, jserver.params), device="cpu"))
    got = server.generate(_requests(mine, Request, temperature))
    assert [len(o) for o in got] == [4, 6, 4]
    for g, w in zip(got, want):
        assert g.dtype == np.int32
        np.testing.assert_array_equal(g, w)
    assert all(np.array_equal(a, b) for a, b in
               zip(server.generate(_requests(mine, Request, 0.0)),
                   server.generate(_requests(mine, Request, 0.0))))


def test_server_refuses_encoder_only():
    with pytest.raises(ValueError, match="encoder-only"):
        Server(C.get("hubert-xlarge").reduced(), device="cpu")


def test_reduced_server_runs_on_the_cpu_without_reference_weights():
    cfg = C.get("qwen3-1.7b").reduced()
    outs = Server(cfg, max_batch=2, max_seq=32, seed=3, device="cpu").generate(
        [Request(prompt=np.arange(5), max_new_tokens=3),
         Request(prompt=np.arange(7) + 9, max_new_tokens=2)])
    assert [len(o) for o in outs] == [3, 2]
    assert all(((o >= 0) & (o < cfg.vocab)).all() for o in outs)


def test_kernel_wrappers_count_no_launch_on_the_cpu():
    before = (ops.flash_attention.launches, ops.rwkv_time_mix.launches)
    cfg, jmodel, jparams, mine, tmodel, tparams = _models("qwen3-1.7b")
    T.prefill_step(tmodel, tparams, {"tokens": torch.zeros((1, 8), dtype=torch.long)})
    r, k, v, logw, u = (_t(a) for a in _streams(s=64))
    ops.rwkv_time_mix(r, k, v, logw, u)
    assert (ops.flash_attention.launches, ops.rwkv_time_mix.launches) == before
    # meta tensors take the plain route (only shapes flow; the dry run's
    # trace); any device but cpu, meta and cuda raises
    out = ops.flash_attention(r.to("meta"), r.to("meta"), r.to("meta"))
    assert out.device.type == "meta" and out.shape == r.shape
    out = ops.rwkv_time_mix(*(t.to("meta") for t in (r, k, v, logw, u)))
    assert out.device.type == "meta" and out.shape == r.shape
    assert (ops.flash_attention.launches, ops.rwkv_time_mix.launches) == before
    elsewhere = types.SimpleNamespace(device=torch.device("xpu"))
    for fn in (ops.flash_attention, ops.rwkv_time_mix):
        with pytest.raises(ValueError, match="cpu, meta or cuda"):
            ops._route(fn, None, None, elsewhere)
    assert rc.CHUNK == 64 and fa.NEG_INF == JL.NEG_INF
