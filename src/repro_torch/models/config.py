"""Architecture configuration for the assigned model zoo (copy of ``repro.models.config``).

Each assigned architecture gets a module in ``repro_torch.configs`` exporting an
``ArchConfig`` built from this dataclass; ``reduced()`` derives the smoke-test
variant (2 layers, d_model <= 512, <= 4 experts) of the same family.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class ArchConfig:
    name: str
    arch_type: str                  # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 128

    # --- attention variants -------------------------------------------------
    qk_norm: bool = False
    causal: bool = True             # False => encoder-only (no decode shapes)
    sliding_window: int = 0         # >0 => SWA (enables long_500k for dense)
    long_context_window: int = 0    # >0 => long_500k runs an SWA variant
    rope_kind: str = "rope"         # rope | mrope | none
    mrope_sections: Tuple[int, int, int] = (16, 24, 24)
    rope_theta: float = 1e4

    # --- MoE -----------------------------------------------------------------
    n_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0               # expert hidden size (0 => d_ff)
    shared_experts: int = 0         # always-on shared expert MLPs
    first_dense_layers: int = 0     # leading layers with dense FFN (DeepSeek/K2)
    moe_every: int = 1              # MoE each k-th layer (Llama4: 2 = 1:1 interleave)
    capacity_factor: float = 1.25

    # --- mixer kind / hybrid layout ------------------------------------------
    block_kind: str = "attn"        # attn | rwkv6 | jamba
    attn_period: int = 0            # jamba: attn at index attn_offset of each unit
    attn_offset: int = 4
    moe_period: int = 0             # jamba: MoE at odd indices of each unit

    # --- mamba (jamba) ---------------------------------------------------------
    mamba_d_state: int = 16
    mamba_d_conv: int = 4
    mamba_expand: int = 2

    # --- input modality --------------------------------------------------------
    embed_inputs: bool = True       # False => inputs are frame embeddings (audio)
    vlm_image_tokens: int = 0       # >0 => accepts (B, n, d) image embeds (vlm)

    dtype: str = "bfloat16"
    kv_cache_quant: bool = False    # int8 KV cache + per-(pos, head) scales
                                    # (beyond-paper: halves decode cache HBM)
    remat: bool = True
    remat_policy: str = "full"      # full | dots (save matmul outputs,
                                    # recompute only elementwise in backward)
    scan_chunk: int = 0             # >0: chunked closed-form recurrence
                                    # (RWKV6 time-mix) instead of per-token scan
    source: str = ""                # citation

    # ------------------------------------------------------------------
    @property
    def moe(self) -> bool:
        return self.n_experts > 0

    @property
    def d_inner(self) -> int:
        return self.mamba_expand * self.d_model

    @property
    def supports_decode(self) -> bool:
        return self.causal  # encoder-only archs have no decode step

    @property
    def supports_long_context(self) -> bool:
        """long_500k needs sub-quadratic attention at decode."""
        if self.block_kind in ("rwkv6", "jamba"):
            return True
        return self.sliding_window > 0 or self.long_context_window > 0

    def reduced(self) -> "ArchConfig":
        """Smoke-test variant: same family, tiny dims (CPU-runnable)."""
        changes = dict(
            name=self.name + "-smoke",
            n_layers=2,
            d_model=min(self.d_model, 128),
            n_heads=min(self.n_heads, 4),
            n_kv_heads=min(self.n_kv_heads, 2),
            d_ff=min(self.d_ff, 256),
            vocab=min(self.vocab, 512),
            head_dim=32,
            sliding_window=min(self.sliding_window, 16) if self.sliding_window else 0,
            first_dense_layers=min(self.first_dense_layers, 1),
            dtype="float32",
            remat=False,
        )
        if self.moe:
            changes.update(n_experts=4, top_k=min(self.top_k, 2),
                           moe_d_ff=min(self.moe_d_ff or self.d_ff, 128),
                           shared_experts=min(self.shared_experts, 1))
        if self.block_kind == "jamba":
            changes.update(n_layers=8)  # one full jamba unit
        if self.vlm_image_tokens:
            changes.update(vlm_image_tokens=16)
        if self.rope_kind == "mrope":
            changes.update(mrope_sections=(4, 6, 6))
        return dataclasses.replace(self, **changes)

    def params_count(self) -> int:
        """Analytic parameter count (for MODEL_FLOPS = 6*N*D roofline term)."""
        d, hd = self.d_model, self.head_dim
        attn = d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd + self.n_heads * hd * d
        dense_ffn = 3 * d * self.d_ff
        moe_ff = self.moe_d_ff or self.d_ff
        moe_ffn = self.n_experts * 3 * d * moe_ff + d * self.n_experts \
            + self.shared_experts * 3 * d * moe_ff
        mamba_inner = self.d_inner
        mamba = (d * 2 * mamba_inner + mamba_inner * self.mamba_d_conv
                 + mamba_inner * (2 * self.mamba_d_state + 2) + mamba_inner * d)
        rwkv = 4 * d * d + d * d + 2 * d * self.d_ff  # r,k,v,g,o + channel-mix

        total = 0
        for i in range(self.n_layers):
            kind, ffn = self.layer_plan(i)
            if kind == "attn":
                total += attn
            elif kind == "mamba":
                total += mamba
            elif kind == "rwkv6":
                total += rwkv
            if ffn == "dense":
                total += dense_ffn
            elif ffn == "moe":
                total += moe_ffn
        total += self.vocab * d  # embed
        total += d * self.vocab  # head
        return total

    def active_params_count(self) -> int:
        """Active parameters per token (MoE: only top-k + shared experts)."""
        if not self.moe:
            return self.params_count()
        d = self.d_model
        moe_ff = self.moe_d_ff or self.d_ff
        full_moe = self.n_experts * 3 * d * moe_ff
        active_moe = self.top_k * 3 * d * moe_ff
        n_moe_layers = sum(1 for i in range(self.n_layers) if self.layer_plan(i)[1] == "moe")
        return self.params_count() - n_moe_layers * (full_moe - active_moe)

    def layer_plan(self, i: int):
        """(mixer_kind, ffn_kind) for layer i."""
        if self.block_kind == "rwkv6":
            return "rwkv6", "rwkv_ffn"
        if self.block_kind == "jamba":
            pos = i % self.attn_period if self.attn_period else i
            mixer = "attn" if (self.attn_period and pos == self.attn_offset) else "mamba"
            ffn = "moe" if (self.moe_period and pos % self.moe_period == 1) else "dense"
            return mixer, ffn
        ffn = "dense"
        if self.moe and i >= self.first_dense_layers \
                and (i - self.first_dense_layers) % self.moe_every == 0:
            ffn = "moe"
        return "attn", ffn
