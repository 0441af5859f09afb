"""Qwen3 14B: dense GQA with qk-norm.  [hf:Qwen/Qwen3-8B family]"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-14b", arch_type="dense",
    n_layers=40, d_model=5120, n_heads=40, n_kv_heads=8,
    d_ff=17408, vocab=151936, head_dim=128,
    qk_norm=True, rope_theta=1e6,
    long_context_window=4096,  # long_500k runs the SWA variant (DESIGN.md §4)
    source="hf:Qwen/Qwen3-8B (family card)",
)
