"""The port's multimodal inputs against the JAX reference on the CPU:
Qwen2-VL's M-RoPE (``layers.apply_mrope``) and image embeddings, and
HuBERT's frame inputs (encoder-only, non-causal attention, no decode).

Inputs are made with numpy from a seed and handed to both packages; the
reference's weights are carried into the port by ``convert.model_params``.
Every tolerance is stated where it is used.
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

import repro_torch.configs as C
from repro_torch import convert
from repro_torch.launch.serve import Request, Server
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.config import ArchConfig

# The same f32 products and the libraries' cos and sin (a few ulp apart),
# relative to the largest entry.
ROPE_TOL = 1e-6
# Logits of a 2-layer model, relative to their largest entry (as in
# test_torch_models.py): f32 matmuls in another order.
MODEL_TOL = 1e-4
VLM, AUDIO = "qwen2-vl-72b", "hubert-xlarge"


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
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * max(1.0, float(np.abs(want).max())))


def grid_positions(b, s, n_img, side):
    """(B, S, 3) M-RoPE ids in Qwen2-VL's scheme (arXiv:2409.12191 §2.1):
    image patch i < n_img at (0, i // side, i % side), text token j >= n_img
    at t = h = w = side + (j - n_img), after the grid's largest id."""
    i = np.arange(s)
    text = side + i - n_img
    pos = np.stack([np.where(i < n_img, 0, text), np.where(i < n_img, i // side, text),
                    np.where(i < n_img, i % side, text)], -1)
    return np.broadcast_to(pos, (b, s, 3)).astype(np.int32)


# ---------------------------------------------------------------------------
# M-RoPE
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sections,dh", [((4, 6, 6), 32), ((16, 24, 24), 128)])
def test_apply_mrope_and_rotate_match_reference(sections, dh):
    """Three position streams that differ, at the reduced and the full
    sections; ``rotate`` picks M-RoPE from the config."""
    rng = np.random.default_rng(dh)
    x = rng.standard_normal((2, 24, 4, dh)).astype(np.float32)
    pos = np.stack([rng.integers(0, 40, (2, 24)), rng.integers(0, 300, (2, 24)),
                    rng.integers(0, 5000, (2, 24))], -1).astype(np.int32)
    for theta in (1e4, 1e6):
        want = JL.apply_mrope(jnp.asarray(x), jnp.asarray(pos), theta, sections)
        _close(L.apply_mrope(_t(x), torch.as_tensor(pos), theta, sections), want, ROPE_TOL)
    cfg = dataclasses.replace(RC.get(VLM).reduced(), head_dim=dh, mrope_sections=sections)
    _close(L.rotate(ArchConfig(**dataclasses.asdict(cfg)), _t(x), torch.as_tensor(pos)),
           JL.rotate(cfg, jnp.asarray(x), jnp.asarray(pos)), ROPE_TOL)
    with pytest.raises(AssertionError):
        L.apply_mrope(_t(x), torch.as_tensor(pos), 1e4, (4, 4, 4))


def test_mrope_of_equal_streams_is_rope():
    """With t = h = w the angle is RoPE's own f32 product: equal bit for bit."""
    x = _t(np.random.default_rng(1).standard_normal((2, 30, 4, 128)))
    pos = torch.arange(30)[None] + torch.tensor([[0], [500]])
    torch.testing.assert_close(L.apply_mrope(x, pos[..., None].expand(2, 30, 3), 1e6,
                                             (16, 24, 24)),
                               L.apply_rope(x, pos, 1e6), rtol=0, atol=0)


# ---------------------------------------------------------------------------
# Whole models at reduced()
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _models(arch):
    cfg = RC.get(arch).reduced()
    jmodel = JT.build(cfg)
    jparams = jax.jit(lambda k: JT.init_params(jmodel, k)[0])(jax.random.PRNGKey(0))
    mine = C.get(arch).reduced()
    tparams = convert.model_params(mine, jax.tree.map(np.asarray, jparams), device="cpu")
    return cfg, jmodel, jparams, mine, T.build(mine), tparams


def _vlm_batch(cfg, b=2, s=40, seed=1, images=True, positions=True):
    """Tokens, ``cfg.vlm_image_tokens`` image embeddings (f32 x 0.02, the
    reference tests' scale) and their grid positions, for both packages."""
    rng = np.random.default_rng(seed)
    n_img = cfg.vlm_image_tokens
    arrays = {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}
    if images:
        arrays["image_embeds"] = (0.02 * rng.standard_normal((b, n_img, cfg.d_model))
                                  ).astype(np.float32)
    if positions:
        arrays["positions"] = grid_positions(b, s, n_img, int(n_img ** 0.5))
    ref = {k: jnp.asarray(v) for k, v in arrays.items()}
    mine = {k: torch.as_tensor(v).long() if v.dtype == np.int32 else _t(v)
            for k, v in arrays.items()}
    return ref, mine


@pytest.mark.parametrize("images,positions", [(True, True), (True, False), (False, False)])
def test_vlm_forward_and_prefill_match_reference(images, positions):
    """Image embeddings over the first 16 slots and grid positions; without
    positions both packages broadcast arange(S) to the three axes."""
    cfg, jmodel, jparams, mine, tmodel, tparams = _models(VLM)
    ref, got_batch = _vlm_batch(cfg, images=images, positions=positions)
    want, _ = jax.jit(functools.partial(JT.forward, jmodel))(jparams, ref)
    _close(T.forward(tmodel, tparams, got_batch), want, MODEL_TOL)
    want = jax.jit(functools.partial(JT.prefill_step, jmodel))(jparams, ref)
    _close(T.prefill_step(tmodel, tparams, got_batch), want, MODEL_TOL)


def test_image_embeddings_replace_the_first_token_slots():
    cfg, jmodel, jparams, mine, tmodel, tparams = _models(VLM)
    _, batch = _vlm_batch(cfg)
    x = T.embed_inputs(tmodel, tparams, batch)
    n = cfg.vlm_image_tokens
    assert torch.equal(x[:, :n], batch["image_embeds"])
    assert torch.equal(x[:, n:], tparams["embed"][batch["tokens"][:, n:]])
    pos = T.positions_for(tmodel, {}, 7)
    assert tuple(pos.shape) == (1, 7, 3) and torch.equal(pos[..., 2], torch.arange(7)[None])
    # the image moves the last position's logits (tests/test_model_properties.py)
    moved = dict(batch, image_embeds=batch["image_embeds"] + 0.1)
    assert not torch.allclose(T.prefill_step(tmodel, tparams, batch),
                              T.prefill_step(tmodel, tparams, moved))


def _ref_layer_caches(jmodel, cache):
    out = list(cache["prefix"])
    for stacked in cache["pattern"]:
        out += [jax.tree.map(lambda a, r=r: a[r], stacked) for r in range(jmodel.n_rep)]
    return out


def test_vlm_serve_steps_match_reference():
    """Eight text-only decode steps through M-RoPE (pos broadcast to the
    three axes): logits and every layer's KV cache."""
    cfg, jmodel, jparams, mine, tmodel, tparams = _models(VLM)
    step = jax.jit(functools.partial(JT.serve_step, jmodel))
    jcache = JT.init_cache(jmodel, 2, 16)
    tcache = T.init_cache(tmodel, 2, 16, device="cpu")
    toks = np.random.default_rng(2).integers(0, cfg.vocab, (2, 8)).astype(np.int32)
    for pos in range(8):
        want, jcache = step(jparams, jcache, jnp.asarray(toks[:, pos:pos + 1]),
                            jnp.int32(pos))
        got, tcache = T.serve_step(tmodel, tparams, tcache,
                                   torch.as_tensor(toks[:, pos:pos + 1]).long(), pos)
        _close(got, want, MODEL_TOL)
    for mine_c, ref_c in zip(tcache, _ref_layer_caches(jmodel, jcache)):
        for a, b in zip(mine_c, jax.tree.leaves(ref_c)):
            _close(a, b, MODEL_TOL)


def _requests(cfg, cls, temperature):
    rng = np.random.default_rng(0)
    return [cls(prompt=rng.integers(0, cfg.vocab, size=n), max_new_tokens=m,
                temperature=temperature) for n, m in ((5, 4), (8, 6), (3, 4))]


def test_vlm_generate_gives_the_reference_tokens(monkeypatch):
    """``Server`` serves Qwen2-VL text-only, greedy and at temperature 0.8.
    The reference's server is handed the cached reference weights."""
    cfg, jmodel, jparams, mine, tmodel, tparams = _models(VLM)
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


@pytest.mark.parametrize("s", [40, 72])
def test_audio_forward_matches_reference(s):
    """HuBERT's frames (f32 x 0.02) through non-causal attention at Dh 32:
    the logits over every frame."""
    cfg, jmodel, jparams, mine, tmodel, tparams = _models(AUDIO)
    frames = (0.02 * np.random.default_rng(s).standard_normal((2, s, cfg.d_model))
              ).astype(np.float32)
    want, _ = jax.jit(functools.partial(JT.forward, jmodel))(
        jparams, {"inputs": jnp.asarray(frames)})
    _close(T.forward(tmodel, tparams, {"inputs": _t(frames)}), want, MODEL_TOL)
    want = jax.jit(functools.partial(JT.prefill_step, jmodel))(
        jparams, {"inputs": jnp.asarray(frames)})
    _close(T.prefill_step(tmodel, tparams, {"inputs": _t(frames)}), want, MODEL_TOL)


def test_audio_has_no_embedding_and_no_decode_step():
    cfg, jmodel, jparams, mine, tmodel, tparams = _models(AUDIO)
    assert "embed" not in jparams and "embed" not in tparams
    own = T.init_params(tmodel, seed=0, device="cpu")
    assert "embed" not in own and tuple(own["head"].shape) == (cfg.d_model, cfg.vocab)
    assert len(own["layers"]) == cfg.n_layers
    cache = T.init_cache(tmodel, 2, 16, device="cpu")
    with pytest.raises(ValueError, match="encoder-only"):
        T.serve_step(tmodel, tparams, cache, torch.zeros((2, 1), dtype=torch.long), 0)
    with pytest.raises(ValueError, match="encoder-only"):
        Server(mine, device="cpu")
