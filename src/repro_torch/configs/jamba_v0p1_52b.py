"""Jamba v0.1 52B: Mamba+attention 1:7 interleave, MoE 16e top-2.  [arXiv:2403.19887]"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="jamba-v0.1-52b", arch_type="hybrid",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab=65536, head_dim=128,
    block_kind="jamba", attn_period=8, attn_offset=4, moe_period=2,
    n_experts=16, top_k=2, moe_d_ff=14336,
    mamba_d_state=16, mamba_d_conv=4, mamba_expand=2,
    source="arXiv:2403.19887",
)
