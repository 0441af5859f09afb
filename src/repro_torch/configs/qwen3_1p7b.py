"""Qwen3 1.7B: dense GQA with qk-norm.  [hf:Qwen/Qwen3-8B family]"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-1.7b", arch_type="dense",
    n_layers=28, d_model=2048, n_heads=16, n_kv_heads=8,
    d_ff=6144, vocab=151936, head_dim=128,
    qk_norm=True, rope_theta=1e6,
    long_context_window=4096,
    source="hf:Qwen/Qwen3-8B (family card)",
)
