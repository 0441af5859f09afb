"""Kimi K2: trillion-parameter MoE, 384 experts top-8.  [arXiv:2501.kimi2]"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="kimi-k2-1t-a32b", arch_type="moe",
    n_layers=61, d_model=7168, n_heads=64, n_kv_heads=8,
    d_ff=2048, vocab=163840, head_dim=128,
    n_experts=384, top_k=8, moe_d_ff=2048, shared_experts=1,
    first_dense_layers=1,
    source="arXiv:2501.kimi2 (Kimi K2 paper-table config)",
)
