"""HuBERT X-Large: encoder-only audio backbone (frontend stubbed).  [arXiv:2106.07447]"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="hubert-xlarge", arch_type="audio",
    n_layers=48, d_model=1280, n_heads=16, n_kv_heads=16,
    d_ff=5120, vocab=504, head_dim=80,
    causal=False, embed_inputs=False,
    source="arXiv:2106.07447 (same arch as wav2vec2 XL)",
)
