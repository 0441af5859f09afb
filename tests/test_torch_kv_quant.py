"""The port's int8 KV cache (``layers.quantize_kv``/``dequantize_kv`` and
``decode_attention`` under ``kv_cache_quant``) against the JAX reference on
the CPU.

Given the same f32 values, the payloads and the f16 scales must be the
reference's bit for bit.  Inside a model the keys and values come from each
package's own matmuls, a few ulp apart, so a payload may move by one step
where a value lies at a rounding edge: such differences are counted, held
to one step and to a small share, and every float is held within a
tolerance stated where it is used.  The port is held to the reference's
outputs, not to ``tests/test_kv_quant.py``'s round-trip bound (which the
reference's f16 scales miss; ROADMAP, "Reference caveats").
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
from repro.models import layers as JL
from repro.models import transformer as JT

from repro_torch import convert
from repro_torch.launch.serve import Request, Server
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.config import ArchConfig

# Attention outputs and logits in f32, relative to their largest entry: the
# matmuls' summation order, and the past keys and values dequantized from
# payloads that may differ by one step (below).
KV_TOL = 1e-4
# Share of payload entries allowed to differ (by one step) between the
# packages after a few decode steps of model-made keys and values.
MAX_EDGE_SHARE = 1e-3


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


def _close(got, want, tol):
    got = got.detach().to(torch.float32).numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * max(1.0, float(np.abs(want).max())))


def _mine(cfg):
    return ArchConfig(**dataclasses.asdict(cfg))


# (shape, std): Dh 128; Dh 40 (one group of 40); f16-subnormal scales;
# large values; and an all-zero group in each.
QUANT_CASES = [((4, 64, 8, 128), 3.0), ((2, 33, 4, 40), 1.0), ((2, 16, 2, 32), 1e-6),
               ((3, 50, 8, 128), 100.0)]


@pytest.mark.parametrize("shape,std", QUANT_CASES)
def test_quantize_kv_is_the_reference_bit_for_bit(shape, std):
    rng = np.random.default_rng(len(shape) + shape[-1])
    x = (std * rng.standard_normal(shape)).astype(np.float32)
    g = L._kv_groups(shape[-1])
    x[0, 0, 0, :g] = 0.0
    jq, js = JL.quantize_kv(jnp.asarray(x))
    tq, ts = L.quantize_kv(_t(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float16
    assert tuple(ts.shape) == shape[:-1] + (shape[-1] // g,)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.view(torch.int16).numpy(), np.asarray(js).view(np.int16))
    np.testing.assert_array_equal(L.dequantize_kv(tq, ts).numpy(),
                                  np.asarray(JL.dequantize_kv(jq, js)))
    assert not bool(tq[0, 0, 0, :g].any())     # the zero group: payload 0, scale 1e-8
    if std == 1e-6:                         # the case exists to reach f16 subnormals
        assert bool((ts.abs() < torch.finfo(torch.float16).tiny).any())


def test_quantize_kv_rounds_half_to_even():
    """Values that fall exactly halfway between two steps, as jnp.round."""
    x = np.zeros((1, 1, 1, 16), np.float32)
    x[..., 0] = 127.0                        # scale 1 + 1e-8: rounds to 1.0 in f32
    x[..., 1:6] = [0.5, 1.5, 2.5, -0.5, -2.5]
    jq, _ = JL.quantize_kv(jnp.asarray(x))
    tq, _ = L.quantize_kv(_t(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert tq[0, 0, 0, 1:6].tolist() == [0, 2, 2, 0, -2]


def _payload_edges(got, want):
    """Count of payload entries that differ, all by one step at most."""
    diff = np.abs(got.numpy().astype(np.int32) - np.asarray(want).astype(np.int32))
    assert diff.max() <= 1, diff.max()
    return int((diff > 0).sum()), diff.size


def _assert_cache_close(mine, ref):
    """(k_i8, v_i8, k_scale, v_scale): payloads within one step at rare
    places, scales and the dequantized cache within KV_TOL."""
    edges = [_payload_edges(a, b) for a, b in zip(mine[:2], ref[:2])]
    n_diff, n = map(sum, zip(*edges))
    assert n_diff <= MAX_EDGE_SHARE * n, (n_diff, n)
    for a, b in zip(mine[2:], ref[2:]):
        assert a.dtype == torch.float16
        _close(a, b, KV_TOL)
    for (qa, sa), (qb, sb) in zip(((mine[0], mine[2]), (mine[1], mine[3])),
                                  ((ref[0], ref[2]), (ref[1], ref[3]))):
        _close(L.dequantize_kv(qa, sa), JL.dequantize_kv(qb, sb), KV_TOL)
    return n_diff


def _qwen(**kw):
    return dataclasses.replace(RC.get("qwen3-1.7b").reduced(), kv_cache_quant=True, **kw)


@pytest.mark.parametrize("window", [0, 8])
def test_quantized_decode_attention_matches_reference(window):
    """12 decode steps; with window 8 the cache is an 8-slot ring buffer.
    The cache is written in place and returned as the four tensors."""
    cfg = _qwen(sliding_window=window)
    p, _ = JL.init_attn(jax.random.PRNGKey(1), cfg)
    rng = np.random.default_rng(3)
    p = dict(p, q_norm=jnp.asarray(0.1 * rng.standard_normal(32), jnp.float32),
             k_norm=jnp.asarray(0.1 * rng.standard_normal(32), jnp.float32))
    jcache = JT.init_cache_entry(cfg, ("attn", "dense"), 2, 16)
    tcache = T.init_cache_entry(_mine(cfg), ("attn", "dense"), 2, 16, device="cpu")
    assert [tuple(a.shape) for a in tcache] == [tuple(a.shape) for a in jcache]
    assert [a.dtype for a in tcache] == [torch.int8, torch.int8, torch.float16, torch.float16]
    tp = {n: _t(a) for n, a in p.items()}
    step = jax.jit(functools.partial(JL.decode_attention, cfg))
    for pos in range(12):
        x = 0.5 * rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
        want, jcache = step(p, jnp.asarray(x), jnp.int32(pos), jcache)
        got, out_cache = L.decode_attention(_mine(cfg), tp, _t(x), pos, tcache)
        assert len(out_cache) == 4 and all(a is b for a, b in zip(out_cache, tcache))
        _close(got, want, KV_TOL)
        _assert_cache_close(tcache, jcache)
    written = min(12, tcache[0].shape[1])
    assert bool((tcache[2][:, :written] > 0).all()) and not bool(tcache[0][:, written:].any())


@functools.lru_cache(maxsize=None)
def _models():
    cfg = _qwen()
    jmodel = JT.build(cfg)
    jparams = jax.jit(lambda k: JT.init_params(jmodel, k)[0])(jax.random.PRNGKey(0))
    mine = _mine(cfg)
    tparams = convert.model_params(mine, jax.tree.map(np.asarray, jparams), device="cpu")
    return cfg, jmodel, jparams, mine, T.build(mine), tparams


def _ref_layer_caches(jmodel, cache):
    out = list(cache["prefix"])
    for stacked in cache["pattern"]:
        out += [jax.tree.map(lambda a, r=r: a[r], stacked) for r in range(jmodel.n_rep)]
    return out


def test_quantized_serve_steps_match_reference():
    """Eight decode steps of the reduced qwen3 with int8 caches: logits
    within KV_TOL, and each layer's cache (payloads within one step at rare
    places, scales and dequantized values within KV_TOL)."""
    cfg, jmodel, jparams, mine, tmodel, tparams = _models()
    step = jax.jit(functools.partial(JT.serve_step, jmodel))
    jcache = JT.init_cache(jmodel, 2, 16)
    tcache = T.init_cache(tmodel, 2, 16, device="cpu")
    toks = np.random.default_rng(2).integers(0, cfg.vocab, (2, 8)).astype(np.int32)
    for pos in range(8):
        want, jcache = step(jparams, jcache, jnp.asarray(toks[:, pos:pos + 1]),
                            jnp.int32(pos))
        got, tcache = T.serve_step(tmodel, tparams, tcache,
                                   torch.as_tensor(toks[:, pos:pos + 1]).long(), pos)
        _close(got, want, KV_TOL)
    for mine_c, ref_c in zip(tcache, _ref_layer_caches(jmodel, jcache)):
        _assert_cache_close(mine_c, jax.tree.leaves(ref_c))


def _cache_bytes(cfg, batch, s_max):
    model = T.build(_mine(cfg))
    return sum(t.numel() * t.element_size()
               for entry in T.init_cache(model, batch, s_max, device="cpu") for t in entry)


@pytest.mark.parametrize("head_dim", [32, 40, 128])
def test_cache_footprint_is_the_references(head_dim):
    """The reference's cache bytes: 0.5625x of the bf16 cache where Dh is a
    multiple of the group of 16, one scale per head vector otherwise."""
    cfg = dataclasses.replace(RC.get("qwen3-1.7b").reduced(), dtype="bfloat16",
                              head_dim=head_dim)
    quant = dataclasses.replace(cfg, kv_cache_quant=True)
    full, small = _cache_bytes(cfg, 4, 64), _cache_bytes(quant, 4, 64)
    g = L._kv_groups(head_dim)
    assert small == full * (head_dim + 2 * head_dim // g) / (2 * head_dim) <= 0.6 * full
    ref = jax.eval_shape(lambda: JT.init_cache(JT.build(quant), 4, 64))
    assert small == sum(leaf.size * leaf.dtype.itemsize for leaf in jax.tree.leaves(ref))


def _requests(cfg, cls, temperature):
    rng = np.random.default_rng(0)
    return [cls(prompt=rng.integers(0, cfg.vocab, size=n), max_new_tokens=m,
                temperature=temperature) for n, m in ((5, 4), (8, 6), (3, 4))]


def test_quantized_server_gives_the_reference_tokens(monkeypatch):
    """``Server`` on an int8-cache config, greedy and at temperature 0.8.
    The reference's server is handed the cached reference weights."""
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
