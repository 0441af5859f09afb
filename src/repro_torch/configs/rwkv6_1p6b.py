"""RWKV-6 "Finch" 1.6B: attention-free, data-dependent decay.  [arXiv:2404.05892]"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="rwkv6-1.6b", arch_type="ssm",
    n_layers=24, d_model=2048, n_heads=32, n_kv_heads=32,
    d_ff=7168, vocab=65536, head_dim=64,
    block_kind="rwkv6", rope_kind="none",
    source="arXiv:2404.05892 (Finch)",
)
