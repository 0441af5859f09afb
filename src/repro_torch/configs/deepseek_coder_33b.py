"""DeepSeek-Coder 33B: dense llama-arch GQA.  [arXiv:2401.14196]"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-coder-33b", arch_type="dense",
    n_layers=62, d_model=7168, n_heads=56, n_kv_heads=8,
    d_ff=19200, vocab=32256, head_dim=128,
    source="arXiv:2401.14196",
)
