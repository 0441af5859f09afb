"""Synthetic token pipeline for LM training (copy of ``repro.data``).

A deterministic, seedable stream of (tokens, labels) batches with a
controllable Markov structure so the LM loss actually decreases -- pure
random tokens would have no learnable signal.  The generator is
host-side numpy (as a real input pipeline would be); ``stream`` iterates
it.  The reference's ``__iter__``, which reads attributes nothing sets, is
not copied.
"""
from __future__ import annotations

from typing import Dict, Iterator, Optional

import numpy as np

from repro_torch.models.config import ArchConfig


class TokenPipeline:
    """Order-1 Markov token stream over an effective alphabet.

    ``alpha`` controls predictability: each row of the transition matrix is
    a Dirichlet(alpha) draw -- small alpha => peaked rows => low entropy.
    """

    def __init__(self, vocab: int, *, seed: int = 0, effective_vocab: int = 256,
                 alpha: float = 0.01):
        self.vocab = vocab
        self.eff = min(effective_vocab, vocab)
        rng = np.random.default_rng(seed)
        self.trans = rng.dirichlet(np.full(self.eff, alpha), size=self.eff)
        self.cum = np.cumsum(self.trans, axis=1)
        # map effective ids onto the full vocab (spread out)
        self.id_map = (np.arange(self.eff) * max(vocab // self.eff, 1)) % vocab
        self.rng = rng

    def batch(self, batch: int, seq: int) -> Dict[str, np.ndarray]:
        u = self.rng.random((batch, seq))
        toks = np.empty((batch, seq + 1), np.int64)
        toks[:, 0] = self.rng.integers(0, self.eff, batch)
        for t in range(seq):
            toks[:, t + 1] = (
                self.cum[toks[:, t]] < u[:, t][:, None]).sum(axis=1)
        mapped = self.id_map[toks]
        return {"tokens": mapped[:, :-1].astype(np.int32),
                "labels": mapped[:, 1:].astype(np.int32)}

    def stream(self, batch: int, seq: int) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            yield self.batch(batch, seq)


def batches_for(cfg: ArchConfig, batch: int, seq: int, *, seed: int = 0,
                n: Optional[int] = None):
    """Batch iterator with the modality extras each arch needs."""
    pipe = TokenPipeline(cfg.vocab, seed=seed)
    rng = np.random.default_rng(seed + 1)
    it = pipe.stream(batch, seq)
    count = 0
    for b in it:
        if not cfg.embed_inputs:  # audio: frame embeddings replace tokens
            b = {"inputs": rng.standard_normal(
                (batch, seq, cfg.d_model)).astype(np.float32) * 0.02,
                "labels": b["labels"] % cfg.vocab}
        elif cfg.vlm_image_tokens:
            b = dict(b)
            b["image_embeds"] = rng.standard_normal(
                (batch, cfg.vlm_image_tokens, cfg.d_model)).astype(np.float32) * 0.02
            if cfg.rope_kind == "mrope":
                pos = np.broadcast_to(np.arange(seq)[None, :, None],
                                      (batch, seq, 3)).astype(np.int32)
                b["positions"] = np.ascontiguousarray(pos)
        yield b
        count += 1
        if n is not None and count >= n:
            return
