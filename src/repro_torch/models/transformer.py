"""Model assembly: layer plans -> per-layer parameters -> prefill and serve
(port of ``repro.models.transformer``).

``plan_groups`` factors the layer sequence into (prefix, pattern, n_rep) as
the reference does.  The reference stacks each pattern position's ``n_rep``
layers and scans over them; the port keeps one parameter dictionary per
layer in ``params["layers"]``, in the order the reference runs them: the
prefix, then for each pattern position its ``n_rep`` repetitions
(``layer_plans``).  The KV / RWKV cache is a list in the same order.

Ported: dense attention stacks (``attn`` mixer, ``dense`` FFN) and RWKV-6
(``rwkv6`` mixer, ``rwkv_ffn``), token inputs, RoPE, sliding windows.
``build`` refuses what is not ported yet: MoE, Mamba (Jamba), M-RoPE and
image embeddings (Qwen2-VL), audio frame inputs (HuBERT) and the int8 KV
cache.  ``forward`` returns logits only; the losses and training come
later.
"""
from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Tuple

import torch

from repro_torch import resolve_device
from . import rwkv6 as rwkv_mod
from .config import ArchConfig
from .layers import attention, decode_attention, dtype_of, ffn, init_attn, init_ffn, \
    normal, rmsnorm


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


def _missing_parts(cfg: ArchConfig) -> List[str]:
    plans = {cfg.layer_plan(i) for i in range(cfg.n_layers)}
    missing = []
    if any(ffn_kind == "moe" for _, ffn_kind in plans):
        missing.append("moe (mixture-of-experts FFN)")
    if any(mixer == "mamba" for mixer, _ in plans):
        missing.append("mamba (Jamba's SSM mixer)")
    if cfg.rope_kind == "mrope" or cfg.vlm_image_tokens:
        missing.append("mrope and image embeddings (VLM inputs)")
    if not cfg.embed_inputs:
        missing.append("audio inputs (frame embeddings)")
    if cfg.kv_cache_quant:
        missing.append("kv_cache_quant (int8 KV cache)")
    return missing


def build(cfg: ArchConfig) -> Model:
    missing = _missing_parts(cfg)
    if missing:
        raise NotImplementedError(f"{cfg.name}: not ported yet: {', '.join(missing)}")
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
    elif mixer == "rwkv6":
        params["mixer"] = rwkv_mod.init_rwkv(gen, cfg)
    else:
        raise NotImplementedError(f"mixer {mixer!r} is not ported yet")
    if ffn_kind != "rwkv_ffn":  # rwkv channel-mix lives inside its mixer params
        params["ln2"] = torch.zeros((cfg.d_model,), dtype=dt, device=gen.device)
        if ffn_kind != "dense":
            raise NotImplementedError(f"ffn {ffn_kind!r} is not ported yet")
        params["ffn"] = init_ffn(gen, cfg)
    return params


# rwkv needs a second norm param that is not gated behind ffn_kind
def _patch_rwkv_lns(cfg: ArchConfig, params: Dict, plan) -> None:
    if plan[0] == "rwkv6":
        params["ln2_rwkv"] = torch.zeros((cfg.d_model,), dtype=dtype_of(cfg),
                                         device=params["ln1"].device)


def apply_layer(cfg: ArchConfig, plan, params, x: torch.Tensor,
                positions: torch.Tensor) -> torch.Tensor:
    """Training / prefill layer (the reference's aux loss is MoE-only)."""
    mixer, ffn_kind = plan
    if mixer == "attn":
        x = x + attention(cfg, params["mixer"], rmsnorm(x, params["ln1"]), positions)
    elif mixer == "rwkv6":
        st0 = rwkv_mod.init_rwkv_state(cfg, x.shape[0], x.dtype, x.device)
        x = x + rwkv_mod.time_mix_prefill(cfg, params["mixer"], rmsnorm(x, params["ln1"]))
        y, _ = rwkv_mod.channel_mix(cfg, params["mixer"], rmsnorm(x, params["ln2_rwkv"]),
                                    st0)
        return x + y
    else:
        raise NotImplementedError(f"mixer {mixer!r} is not ported yet")
    if ffn_kind == "dense":
        x = x + ffn(params["ffn"], rmsnorm(x, params["ln2"]))
    return x


def decode_layer(cfg: ArchConfig, plan, params, x: torch.Tensor, pos: int, cache):
    """One-token decode layer.  Returns (x, new_cache)."""
    mixer, ffn_kind = plan
    if mixer == "attn":
        y, cache = decode_attention(cfg, params["mixer"], rmsnorm(x, params["ln1"]),
                                    pos, cache)
        x = x + y
    elif mixer == "rwkv6":
        y, cache = rwkv_mod.decode_step(cfg, params["mixer"], rmsnorm(x, params["ln1"]),
                                        cache)
        x = x + y
        y, cache = rwkv_mod.decode_channel_mix(
            cfg, params["mixer"], rmsnorm(x, params["ln2_rwkv"]), cache)
        return x + y, cache
    else:
        raise NotImplementedError(f"mixer {mixer!r} is not ported yet")
    if ffn_kind == "dense":
        x = x + ffn(params["ffn"], rmsnorm(x, params["ln2"]))
    return x, cache


# ---------------------------------------------------------------------------
# Whole-model init
# ---------------------------------------------------------------------------


def init_params(model: Model, seed: int = 0, device="cuda") -> Dict[str, Any]:
    """Random weights from a ``torch.Generator`` seeded with ``seed``, drawn
    on ``device`` in the config's dtype.  Not the reference's values (those
    are threefry draws): ``convert.model_params`` carries them across."""
    cfg = model.cfg
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    d, v = cfg.d_model, cfg.vocab
    dt = dtype_of(cfg)
    params: Dict[str, Any] = {"embed": normal(gen, (v, d), d ** -0.5, dt), "layers": []}
    for plan in layer_plans(model):
        p = init_layer(gen, cfg, plan)
        _patch_rwkv_lns(cfg, p, plan)
        params["layers"].append(p)
    params["final_norm"] = torch.zeros((d,), dtype=dt, device=dev)
    params["head"] = normal(gen, (d, v), d ** -0.5, dt)
    return params


# ---------------------------------------------------------------------------
# Forward (prefill)
# ---------------------------------------------------------------------------


def embed_inputs(model: Model, params, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    if "image_embeds" in batch:
        raise NotImplementedError("image embeddings (VLM inputs) are not ported yet")
    return params["embed"][batch["tokens"]]


def positions_for(model: Model, batch: Dict[str, torch.Tensor], s: int,
                  device=None) -> torch.Tensor:
    if "positions" in batch:
        return batch["positions"]
    return torch.arange(s, device=device)[None]


def _backbone(model: Model, params, batch) -> torch.Tensor:
    x = embed_inputs(model, params, batch)
    positions = positions_for(model, batch, x.shape[1], x.device)
    for plan, p in zip(layer_plans(model), params["layers"]):
        x = apply_layer(model.cfg, plan, p, x, positions)
    return x


@torch.no_grad()
def forward(model: Model, params, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Logits (B, S, V) in the model dtype."""
    x = _backbone(model, params, batch)
    return rmsnorm(x, params["final_norm"]) @ params["head"]


@torch.no_grad()
def prefill_step(model: Model, params, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Serving prefill: full forward, last-position logits only (B, 1, V)."""
    x = _backbone(model, params, batch)
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
        return (torch.zeros(shape, dtype=dt, device=dev),
                torch.zeros(shape, dtype=dt, device=dev))
    if mixer == "rwkv6":
        return rwkv_mod.init_rwkv_state(cfg, batch, dt, dev)
    raise NotImplementedError(f"mixer {mixer!r} is not ported yet")


def init_cache(model: Model, batch: int, s_max: int, device="cuda") -> List:
    """One cache entry per layer, in ``layer_plans`` order."""
    return [init_cache_entry(model.cfg, plan, batch, s_max, device)
            for plan in layer_plans(model)]


@torch.no_grad()
def serve_step(model: Model, params, cache: List, tokens: torch.Tensor, pos: int):
    """One decode step: tokens (B, 1) -> (logits (B, 1, V), new_cache).

    ``pos`` is the current absolute position (== tokens so far).  KV caches
    are updated in place (``layers.decode_attention``).
    """
    x = params["embed"][tokens]
    new_cache = []
    for plan, p, c in zip(layer_plans(model), params["layers"], cache):
        x, c = decode_layer(model.cfg, plan, p, x, pos, c)
        new_cache.append(c)
    return rmsnorm(x, params["final_norm"]) @ params["head"], new_cache
