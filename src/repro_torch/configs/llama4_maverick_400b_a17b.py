"""Llama-4 Maverick 400B-A17B: MoE 128e top-1 + shared expert, early fusion.
[hf:meta-llama/Llama-4-Scout-17B-16E]"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="llama4-maverick-400b-a17b", arch_type="moe",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8,
    d_ff=8192, vocab=202048, head_dim=128,
    n_experts=128, top_k=1, moe_d_ff=8192, shared_experts=1,
    moe_every=2,  # Maverick interleaves dense::MoE 1:1
    long_context_window=8192,  # chunked-local attention stands in for long ctx
    source="hf:meta-llama/Llama-4-Scout-17B-16E (family card)",
)
