"""Model assembly: layer plans -> per-layer parameters -> prefill and serve
(port of ``repro.models.transformer``).

``plan_groups`` factors the layer sequence into (prefix, pattern, n_rep) as
the reference does.  The reference stacks each pattern position's ``n_rep``
layers and scans over them; the port keeps one parameter dictionary per
layer in ``params["layers"]``, in the order the reference runs them: the
prefix, then for each pattern position its ``n_rep`` repetitions
(``layer_plans``).  The KV / RWKV / Mamba cache is a list in the same order.
Where ``n_rep`` > 1 in a hybrid stack this is not the published interleave:
Jamba at full depth (a pattern of 8 layers, ``n_rep`` 4) runs its four
first-position Mamba layers first, then the four of the second position,
and so on, as the reference does.

Ported: attention (``attn``, causal or not), RWKV-6 (``rwkv6`` mixer,
``rwkv_ffn``) and Mamba (``mamba``) mixers; dense and MoE (``moe``, with
shared experts, ``first_dense_layers`` and ``moe_every``) FFNs; token
inputs, image embeddings spliced over the first token slots (Qwen2-VL),
audio frame inputs (HuBERT, ``embed_inputs=False``: no ``embed`` and no
decode step); RoPE, M-RoPE, sliding windows; the bf16 and the int8
(``kv_cache_quant``) KV caches.  ``build`` takes every config in
``repro_torch.configs``.  ``forward`` returns logits, and with
``return_aux`` the MoE layers' summed load-balance loss.

Training: ``lm_loss`` and ``encoder_loss`` run the same backbone with
autograd on, each layer after the prefix wrapped in
``torch.utils.checkpoint`` when ``cfg.remat`` is set (the reference's
``jax.checkpoint`` of its scanned layers; the ``dots`` policy's saved
matmul outputs have no counterpart, and no config uses it).  The trainer
(``launch/train.py``) holds the reference's stacked tree and hands these
functions per-layer views of it (``convert.layer_views``).

Sharding metadata (the dry run's, ``launch/dryrun.py``): ``param_specs``
is the reference's spec tree for the stacked layout, ``abstract_init``
that layout's parameters on the ``meta`` device (shapes and dtypes, no
storage), ``fsdp_specs`` the ZeRO-3 refinement, and ``cache_entry_spec`` /
``cache_specs`` the decode caches' specs (the reference's stacked tree; a
layer of the port's cache list takes its stacked spec less the leading
``None``).
"""
from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten
from . import mamba as mamba_mod
from . import moe as moe_mod
from . import rwkv6 as rwkv_mod
from . import sharding
from .config import ArchConfig
from .layers import MetaGenerator, _kv_groups, attention, attn_specs, decode_attention, \
    dtype_of, ffn, ffn_specs, init_attn, init_ffn, kv_head_spec, normal, rmsnorm
from .sharding import P, is_spec


# ---------------------------------------------------------------------------
# Layer plans -> (prefix, pattern, n_rep)
# ---------------------------------------------------------------------------


def plan_groups(cfg: ArchConfig) -> Tuple[List, List, int]:
    plans = [cfg.layer_plan(i) for i in range(cfg.n_layers)]
    # strip a non-repeating prefix (leading dense layers of MoE stacks)
    prefix_len = 0
    if cfg.moe and cfg.first_dense_layers:
        prefix_len = cfg.first_dense_layers
    prefix, rest = plans[:prefix_len], plans[prefix_len:]
    for p in range(1, len(rest) + 1):
        if len(rest) % p == 0 and rest == rest[:p] * (len(rest) // p):
            return prefix, rest[:p], len(rest) // p
    return prefix, rest, 1


class Model(NamedTuple):
    cfg: ArchConfig
    prefix: List        # list of plans
    pattern: List       # repeating unit of plans
    n_rep: int


def build(cfg: ArchConfig) -> Model:
    prefix, pattern, n_rep = plan_groups(cfg)
    return Model(cfg=cfg, prefix=prefix, pattern=pattern, n_rep=n_rep)


def layer_plans(model: Model) -> List:
    """Each layer's plan, in the order the layers run."""
    return list(model.prefix) + [plan for plan in model.pattern for _ in range(model.n_rep)]


# ---------------------------------------------------------------------------
# Single-layer init / apply
# ---------------------------------------------------------------------------


def init_layer(gen: torch.Generator, cfg: ArchConfig, plan) -> Dict[str, Any]:
    mixer, ffn_kind = plan
    dt = dtype_of(cfg)
    params: Dict[str, Any] = {"ln1": torch.zeros((cfg.d_model,), dtype=dt, device=gen.device)}
    if mixer == "attn":
        params["mixer"] = init_attn(gen, cfg)
    elif mixer == "mamba":
        params["mixer"] = mamba_mod.init_mamba(gen, cfg)
    elif mixer == "rwkv6":
        params["mixer"] = rwkv_mod.init_rwkv(gen, cfg)
    else:
        raise ValueError(mixer)
    if ffn_kind != "rwkv_ffn":  # rwkv channel-mix lives inside its mixer params
        params["ln2"] = torch.zeros((cfg.d_model,), dtype=dt, device=gen.device)
        if ffn_kind == "dense":
            params["ffn"] = init_ffn(gen, cfg)
        elif ffn_kind == "moe":
            params["ffn"] = moe_mod.init_moe(gen, cfg)
        else:
            raise ValueError(ffn_kind)
    return params


# rwkv needs a second norm param that is not gated behind ffn_kind
def _patch_rwkv_lns(cfg: ArchConfig, params: Dict, plan) -> None:
    if plan[0] == "rwkv6":
        params["ln2_rwkv"] = torch.zeros((cfg.d_model,), dtype=dtype_of(cfg),
                                         device=params["ln1"].device)


def layer_specs(cfg: ArchConfig, plan) -> Dict[str, Any]:
    """One layer's specs, the tree of ``init_layer`` + ``_patch_rwkv_lns``."""
    mixer, ffn_kind = plan
    specs: Dict[str, Any] = {"ln1": P(None)}
    if mixer == "attn":
        specs["mixer"] = attn_specs(cfg)
    elif mixer == "mamba":
        specs["mixer"] = mamba_mod.mamba_specs(cfg)
    elif mixer == "rwkv6":
        specs["mixer"] = rwkv_mod.rwkv_specs(cfg)
        specs["ln2_rwkv"] = P(None)
    else:
        raise ValueError(mixer)
    if ffn_kind != "rwkv_ffn":
        specs["ln2"] = P(None)
        if ffn_kind == "dense":
            specs["ffn"] = ffn_specs(cfg)
        elif ffn_kind == "moe":
            specs["ffn"] = moe_mod.moe_specs(cfg)
        else:
            raise ValueError(ffn_kind)
    return specs


def apply_layer(cfg: ArchConfig, plan, params, x: torch.Tensor, positions: torch.Tensor,
                *, kv_chunk: int = 1024) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Training / prefill layer.  Returns (x, aux_loss); the aux loss is the
    MoE FFN's, None in every other layer (the reference's 0)."""
    mixer, ffn_kind = plan
    aux = None
    if mixer == "attn":
        x = x + attention(cfg, params["mixer"], rmsnorm(x, params["ln1"]), positions,
                          kv_chunk=kv_chunk)
    elif mixer == "mamba":
        st0 = mamba_mod.init_mamba_state(cfg, x.shape[0], x.dtype, x.device)
        y, _ = mamba_mod.mamba_block(cfg, params["mixer"], rmsnorm(x, params["ln1"]), st0)
        x = x + y
    elif mixer == "rwkv6":
        st0 = rwkv_mod.init_rwkv_state(cfg, x.shape[0], x.dtype, x.device)
        x = x + rwkv_mod.time_mix_prefill(cfg, params["mixer"], rmsnorm(x, params["ln1"]))
        y, _ = rwkv_mod.channel_mix(cfg, params["mixer"], rmsnorm(x, params["ln2_rwkv"]),
                                    st0)
        return x + y, aux
    else:
        raise ValueError(mixer)
    if ffn_kind == "dense":
        x = x + ffn(params["ffn"], rmsnorm(x, params["ln2"]))
    elif ffn_kind == "moe":
        y, aux = moe_mod.moe_ffn(cfg, params["ffn"], rmsnorm(x, params["ln2"]))
        x = x + y
    return x, aux


def decode_layer(cfg: ArchConfig, plan, params, x: torch.Tensor, pos: int, cache):
    """One-token decode layer.  Returns (x, new_cache)."""
    mixer, ffn_kind = plan
    if mixer == "attn":
        y, cache = decode_attention(cfg, params["mixer"], rmsnorm(x, params["ln1"]),
                                    pos, cache)
        x = x + y
    elif mixer == "mamba":
        y, cache = mamba_mod.decode_step(cfg, params["mixer"], rmsnorm(x, params["ln1"]),
                                         cache)
        x = x + y
    elif mixer == "rwkv6":
        y, cache = rwkv_mod.decode_step(cfg, params["mixer"], rmsnorm(x, params["ln1"]),
                                        cache)
        x = x + y
        y, cache = rwkv_mod.decode_channel_mix(
            cfg, params["mixer"], rmsnorm(x, params["ln2_rwkv"]), cache)
        return x + y, cache
    else:
        raise ValueError(mixer)
    if ffn_kind == "dense":
        x = x + ffn(params["ffn"], rmsnorm(x, params["ln2"]))
    elif ffn_kind == "moe":
        # (B, 1, d) is one group of B tokens: dropless (moe.DROPLESS_MAX_GROUP)
        y, _ = moe_mod.moe_ffn(cfg, params["ffn"], rmsnorm(x, params["ln2"]))
        x = x + y
    return x, cache


# ---------------------------------------------------------------------------
# Whole-model init
# ---------------------------------------------------------------------------


def init_params(model: Model, seed: int = 0, device="cuda") -> Dict[str, Any]:
    """Random weights from a ``torch.Generator`` seeded with ``seed``, drawn
    on ``device`` in the config's dtype.  Not the reference's values (those
    are threefry draws): ``convert.model_params`` carries them across.
    A config with frame inputs (``embed_inputs=False``) has no ``embed``."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    return _init(model, gen, layer_plans(model))


def _init(model: Model, gen, plans) -> Dict[str, Any]:
    """``{embed, layers, final_norm, head}`` with one layer per plan."""
    cfg = model.cfg
    d, v = cfg.d_model, cfg.vocab
    dt = dtype_of(cfg)
    params: Dict[str, Any] = {}
    if cfg.embed_inputs:
        params["embed"] = normal(gen, (v, d), d ** -0.5, dt)
    params["layers"] = []
    for plan in plans:
        p = init_layer(gen, cfg, plan)
        _patch_rwkv_lns(cfg, p, plan)
        params["layers"].append(p)
    params["final_norm"] = torch.zeros((d,), dtype=dt, device=gen.device)
    params["head"] = normal(gen, (d, v), d ** -0.5, dt)
    return params


def param_specs(model: Model) -> Dict[str, Any]:
    """The reference's spec tree for the stacked layout ``{embed, prefix,
    pattern, final_norm, head}`` (``convert.stack_model_params``), on the
    active mesh: each pattern leaf's spec gains a leading ``None`` for its
    stacked ``n_rep`` axis."""
    cfg = model.cfg
    specs: Dict[str, Any] = {}
    if cfg.embed_inputs:
        specs["embed"] = sharding.spec_embed()
    specs["prefix"] = [layer_specs(cfg, plan) for plan in model.prefix]
    specs["pattern"] = [tree_map(lambda sp: P(None, *sp), layer_specs(cfg, plan),
                                 is_leaf=is_spec) for plan in model.pattern]
    specs["final_norm"] = P(None)
    specs["head"] = sharding.spec_head()
    return specs


def abstract_init(model: Model) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """(parameters, specs) without allocating: the stacked tree the trainer
    holds (``convert.stack_model_params(model, init_params(model))``), each
    leaf a ``meta`` tensor of its shape and dtype, and ``param_specs``.
    Nothing is drawn: the inits run on a ``layers.MetaGenerator``, one layer
    per pattern position, and the stacked leaves are made ``n_rep`` deep."""
    flat = _init(model, MetaGenerator(), list(model.prefix) + list(model.pattern))
    n_pre = len(model.prefix)
    stack = lambda t: torch.empty((model.n_rep,) + tuple(t.shape), dtype=t.dtype,  # noqa: E731
                                  device="meta")
    params = {"embed": flat["embed"]} if "embed" in flat else {}
    params.update(prefix=flat["layers"][:n_pre],
                  pattern=[tree_map(stack, p) for p in flat["layers"][n_pre:]],
                  final_norm=flat["final_norm"], head=flat["head"])
    return params, param_specs(model)


def fsdp_specs(params, specs, *, min_size: int = 2 ** 16):
    """ZeRO-3 refinement: shard one replicated dim of each large leaf on ``data``.

    Picks the largest dim that is currently None and divides the data-axis
    size; leaves small leaves (norms, biases) replicated.
    """
    data = sharding.axis_size("data")
    if data <= 1:
        return specs

    def refine(leaf, spec):
        if not is_spec(spec) or leaf.numel() < min_size:
            return spec
        entries = list(spec) + [None] * (leaf.dim() - len(spec))
        if "data" in entries:
            return spec
        cands = [i for i, (ax, n) in enumerate(zip(entries, leaf.shape))
                 if ax is None and n % data == 0]
        if not cands:
            return spec
        best = max(cands, key=lambda i: leaf.shape[i])
        entries[best] = "data"
        return P(*entries)

    flat_specs = tree_leaves(specs, is_leaf=is_spec)
    flat_params = tree_leaves(params)
    assert len(flat_specs) == len(flat_params)
    return tree_unflatten(specs, [refine(leaf, s) for leaf, s in zip(flat_params, flat_specs)],
                          is_leaf=is_spec)


# ---------------------------------------------------------------------------
# Forward (prefill)
# ---------------------------------------------------------------------------


def embed_inputs(model: Model, params, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """(B, S, d) in the model dtype: the frames ``batch["inputs"]`` (audio),
    or the token embeddings with, for a VLM given ``image_embeds`` (B, n, d),
    the first n token slots replaced by the image embeddings."""
    cfg = model.cfg
    if not cfg.embed_inputs:
        return batch["inputs"].to(dtype_of(cfg))
    x = params["embed"][batch["tokens"]]
    if cfg.vlm_image_tokens and "image_embeds" in batch:
        img = batch["image_embeds"].to(x.dtype)
        x = torch.cat([img, x[:, img.shape[1]:]], dim=1)
    return x


def positions_for(model: Model, batch: Dict[str, torch.Tensor], s: int,
                  device=None) -> torch.Tensor:
    """``batch["positions"]``, else ``arange(s)`` as (1, S), or (1, S, 3)
    (the same id on each axis) under M-RoPE."""
    if "positions" in batch:
        return batch["positions"]
    pos = torch.arange(s, device=device)[None]
    if model.cfg.rope_kind == "mrope":
        pos = pos[..., None].expand(1, s, 3)
    return pos


def _backbone(model: Model, params, batch, *,
              kv_chunk: int = 1024) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """(hidden states, the MoE layers' aux losses in layer order).  With
    autograd on and ``cfg.remat`` set, each layer after the prefix is
    recomputed in the backward pass instead of keeping its activations."""
    x = embed_inputs(model, params, batch)
    positions = positions_for(model, batch, x.shape[1], x.device)
    remat = model.cfg.remat and torch.is_grad_enabled()
    auxes = []
    for i, (plan, p) in enumerate(zip(layer_plans(model), params["layers"])):
        if remat and i >= len(model.prefix):
            x, aux = checkpoint(apply_layer, model.cfg, plan, p, x, positions,
                                kv_chunk=kv_chunk, use_reentrant=False)
        else:
            x, aux = apply_layer(model.cfg, plan, p, x, positions, kv_chunk=kv_chunk)
        if aux is not None:
            auxes.append(aux)
    return x, auxes


def _aux_total(auxes: List[torch.Tensor], device) -> torch.Tensor:
    # the reference adds every layer's aux to 0 in layer order; its dense
    # layers' zeros change no sum
    return sum(auxes, torch.zeros((), dtype=torch.float32, device=device))


@torch.no_grad()
def forward(model: Model, params, batch: Dict[str, torch.Tensor], *,
            return_aux: bool = False):
    """Logits (B, S, V) in the model dtype; with ``return_aux``, (logits,
    the MoE load-balance loss summed over the layers), as the reference's
    ``forward`` returns them."""
    x, auxes = _backbone(model, params, batch)
    logits = rmsnorm(x, params["final_norm"]) @ params["head"]
    if not return_aux:
        return logits
    return logits, _aux_total(auxes, x.device)


def lm_loss(model: Model, params, batch: Dict[str, torch.Tensor], *,
            aux_weight: float = 0.01, kv_chunk: int = 1024) -> torch.Tensor:
    """Mean next-token cross-entropy over ``batch["labels"]`` (B, S), from
    f32 logits (``logsumexp`` minus the gold logit), plus ``aux_weight``
    times the MoE layers' summed load-balance loss: a 0-d f32 tensor,
    differentiable in ``params``."""
    x, auxes = _backbone(model, params, batch, kv_chunk=kv_chunk)
    logits = rmsnorm(x, params["final_norm"]) @ params["head"]
    lf = logits.to(torch.float32)
    logz = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, batch["labels"].to(torch.int64)[..., None])[..., 0]
    return (logz - gold).mean() + aux_weight * _aux_total(auxes, x.device)


def encoder_loss(model: Model, params, batch: Dict[str, torch.Tensor], *,
                 kv_chunk: int = 1024) -> torch.Tensor:
    """Frame-classification cross-entropy for the encoder-only (audio) arch."""
    return lm_loss(model, params, batch, aux_weight=0.0, kv_chunk=kv_chunk)


@torch.no_grad()
def prefill_step(model: Model, params, batch: Dict[str, torch.Tensor], *,
                 kv_chunk: int = 1024) -> torch.Tensor:
    """Serving prefill: full forward, last-position logits only (B, 1, V).
    ``kv_chunk`` is the plain attention's chunk (the kernel has none)."""
    x, _ = _backbone(model, params, batch, kv_chunk=kv_chunk)
    return rmsnorm(x[:, -1:], params["final_norm"]) @ params["head"]


# ---------------------------------------------------------------------------
# Decode (serve_step)
# ---------------------------------------------------------------------------


def init_cache_entry(cfg: ArchConfig, plan, batch: int, s_max: int, device="cuda"):
    mixer = plan[0]
    dt = dtype_of(cfg)
    dev = resolve_device(device)
    if mixer == "attn":
        s_alloc = min(s_max, cfg.sliding_window) if cfg.sliding_window else s_max
        shape = (batch, s_alloc, cfg.n_kv_heads, cfg.head_dim)
        if cfg.kv_cache_quant:
            sshape = shape[:-1] + (cfg.head_dim // _kv_groups(cfg.head_dim),)
            return (torch.zeros(shape, dtype=torch.int8, device=dev),
                    torch.zeros(shape, dtype=torch.int8, device=dev),
                    torch.zeros(sshape, dtype=torch.float16, device=dev),
                    torch.zeros(sshape, dtype=torch.float16, device=dev))
        return (torch.zeros(shape, dtype=dt, device=dev),
                torch.zeros(shape, dtype=dt, device=dev))
    if mixer == "mamba":
        return mamba_mod.init_mamba_state(cfg, batch, dt, dev)
    if mixer == "rwkv6":
        return rwkv_mod.init_rwkv_state(cfg, batch, dt, dev)
    raise ValueError(mixer)


def cache_entry_spec(cfg: ArchConfig, plan, *, batch: int = 0):
    """Cache specs for one layer, in the layout of its cache entry.

    Default: batch over (pod, data), kv heads / head_dim over model.  When
    the batch does not divide the data axes (the batch-1 long-context
    shape), the KV sequence dim is sharded over data instead: the
    sequence-parallel cache layout.
    """
    mixer = plan[0]
    bspec = sharding.batch_axes()
    data = sharding.axis_size("data") * sharding.axis_size("pod")
    seq_parallel = batch > 0 and batch % max(data, 1) != 0
    if seq_parallel:
        bspec = None
    if mixer == "attn":
        hs = kv_head_spec(cfg, sharding.axis_size("model"), for_cache=True)
        sp = P(bspec, "data" if seq_parallel else None, *hs)
        if cfg.kv_cache_quant:
            ssp = P(bspec, "data" if seq_parallel else None, hs[0], None)
            return (sp, sp, ssp, ssp)
        return (sp, sp)
    if mixer == "mamba":
        return mamba_mod.MambaState(conv=P(bspec, None, "model"), ssm=P(bspec, "model", None))
    if mixer == "rwkv6":
        return rwkv_mod.RWKVState(s=P(bspec, "model", None, None), x_prev_tm=P(bspec, None),
                                  x_prev_cm=P(bspec, None))
    raise ValueError(mixer)


def cache_specs(model: Model, *, batch: int = 0) -> Dict[str, List]:
    """The reference's stacked cache specs ``{prefix, pattern}``: a pattern
    entry's specs gain a leading ``None`` for its ``n_rep`` axis."""
    cfg = model.cfg
    return {
        "prefix": [cache_entry_spec(cfg, plan, batch=batch) for plan in model.prefix],
        "pattern": [tree_map(lambda sp: P(None, *sp), cache_entry_spec(cfg, plan, batch=batch),
                             is_leaf=is_spec) for plan in model.pattern],
    }


def init_cache(model: Model, batch: int, s_max: int, device="cuda") -> List:
    """One cache entry per layer, in ``layer_plans`` order."""
    return [init_cache_entry(model.cfg, plan, batch, s_max, device)
            for plan in layer_plans(model)]


@torch.no_grad()
def serve_step(model: Model, params, cache: List, tokens: torch.Tensor, pos: int):
    """One decode step: tokens (B, 1) -> (logits (B, 1, V), new_cache).

    ``pos`` is the current absolute position (== tokens so far).  KV caches
    are updated in place (``layers.decode_attention``).  An encoder-only
    config (frame inputs) has no decode step: ``ValueError``.
    """
    if not model.cfg.embed_inputs:
        raise ValueError("encoder-only archs have no decode step")
    x = params["embed"][tokens]
    new_cache = []
    for plan, p, c in zip(layer_plans(model), params["layers"], cache):
        x, c = decode_layer(model.cfg, plan, p, x, pos, c)
        new_cache.append(c)
    return rmsnorm(x, params["final_norm"]) @ params["head"], new_cache
