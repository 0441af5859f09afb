"""Assigned-architecture registry (port of ``repro.configs``).

``get(arch_id)`` returns the exact ArchConfig from the assignment table,
``all_configs()`` every one of them by module name; ``models.transformer
.build`` takes each.  ``input_specs(cfg, shape)`` gives ``meta`` tensors
(shape and dtype, no storage) for every model input of one of the four
canonical input shapes: the dry run's inputs.

Shapes:
    train_4k     seq 4,096    global_batch 256   (train_step)
    prefill_32k  seq 32,768   global_batch  32   (prefill forward)
    decode_32k   seq 32,768   global_batch 128   (serve_step, KV cache)
    long_500k    seq 524,288  global_batch   1   (serve_step, sub-quadratic)
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, Optional

import torch

from repro_torch.models.config import ArchConfig

ARCH_IDS = [
    "kimi_k2_1t_a32b",
    "deepseek_coder_33b",
    "rwkv6_1p6b",
    "hubert_xlarge",
    "qwen3_14b",
    "llama4_maverick_400b_a17b",
    "qwen3_1p7b",
    "minitron_8b",
    "qwen2_vl_72b",
    "jamba_v0p1_52b",
]

# public --arch ids (hyphenated) -> module names
ALIASES = {
    "kimi-k2-1t-a32b": "kimi_k2_1t_a32b",
    "deepseek-coder-33b": "deepseek_coder_33b",
    "rwkv6-1.6b": "rwkv6_1p6b",
    "hubert-xlarge": "hubert_xlarge",
    "qwen3-14b": "qwen3_14b",
    "llama4-maverick-400b-a17b": "llama4_maverick_400b_a17b",
    "qwen3-1.7b": "qwen3_1p7b",
    "minitron-8b": "minitron_8b",
    "qwen2-vl-72b": "qwen2_vl_72b",
    "jamba-v0.1-52b": "jamba_v0p1_52b",
}

SHAPES: Dict[str, Dict] = {
    "train_4k": dict(seq=4096, batch=256, kind="train"),
    "prefill_32k": dict(seq=32768, batch=32, kind="prefill"),
    "decode_32k": dict(seq=32768, batch=128, kind="decode"),
    "long_500k": dict(seq=524288, batch=1, kind="decode"),
}


def get(arch_id: str) -> ArchConfig:
    mod_name = ALIASES.get(arch_id, arch_id)
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return mod.CONFIG


def all_configs() -> Dict[str, ArchConfig]:
    return {a: get(a) for a in ARCH_IDS}


def shape_supported(cfg: ArchConfig, shape: str) -> Optional[str]:
    """None if (cfg, shape) is runnable; otherwise the skip reason."""
    info = SHAPES[shape]
    if info["kind"] == "decode":
        if not cfg.supports_decode:
            return "encoder-only: no decode step"
        if shape == "long_500k" and not cfg.supports_long_context:
            return "full quadratic attention: 500k decode cache intractable"
    return None


def for_shape(cfg: ArchConfig, shape: str) -> ArchConfig:
    """Shape-adapted config (e.g. the SWA long-context variant)."""
    if shape == "long_500k" and cfg.long_context_window and not cfg.sliding_window:
        return dataclasses.replace(cfg, sliding_window=cfg.long_context_window)
    return cfg


def input_specs(cfg: ArchConfig, shape: str, *, batch: Optional[int] = None,
                seq: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """``meta`` stand-ins for each input of (cfg, shape), in the reference's
    shapes and dtypes: int32 tokens, labels and positions, f32 frames and
    image embeddings, a 0-d ``pos`` for decode.  ``batch`` and ``seq``
    replace the shape's own (a run cut to a card's size)."""
    info = SHAPES[shape]
    s, b = seq or info["seq"], batch or info["batch"]

    def f(shp, dtype):
        return torch.empty(shp, dtype=dtype, device="meta")

    if info["kind"] == "decode":
        return {"tokens": f((b, 1), torch.int32), "pos": f((), torch.int32)}
    out: Dict[str, torch.Tensor] = {}
    if cfg.embed_inputs:
        out["tokens"] = f((b, s), torch.int32)
    else:
        out["inputs"] = f((b, s, cfg.d_model), torch.float32)
    if cfg.vlm_image_tokens:
        out["image_embeds"] = f((b, cfg.vlm_image_tokens, cfg.d_model), torch.float32)
        if cfg.rope_kind == "mrope":
            out["positions"] = f((b, s, 3), torch.int32)
    if info["kind"] == "train":
        out["labels"] = f((b, s), torch.int32)
    return out
