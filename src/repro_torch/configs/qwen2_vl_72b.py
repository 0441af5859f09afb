"""Qwen2-VL 72B: VLM decoder with M-RoPE (vision tower stubbed).  [arXiv:2409.12191]"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-vl-72b", arch_type="vlm",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=29568, vocab=152064, head_dim=128,
    rope_kind="mrope", mrope_sections=(16, 24, 24),
    vlm_image_tokens=1024,  # dynamic-resolution stub: fixed patch-token count
    source="arXiv:2409.12191",
)
