"""Frozen copy of the LM token stream (the port's ``data.TokenPipeline``):
an order-1 Markov chain over 256 effective ids, each transition row a
Dirichlet(0.01) draw, mapped onto the vocabulary.  Host numpy, as an input
pipeline is; every batch of a stream differs from the others."""
from __future__ import annotations

from typing import Dict, Iterator

import numpy as np


class TokenStream:
    def __init__(self, vocab: int, seed: int, effective_vocab: int = 256,
                 alpha: float = 0.01):
        self.eff = min(effective_vocab, vocab)
        rng = np.random.default_rng(seed)
        trans = rng.dirichlet(np.full(self.eff, alpha), size=self.eff)
        self.cum = np.cumsum(trans, axis=1)
        self.id_map = (np.arange(self.eff) * max(vocab // self.eff, 1)) % vocab
        self.rng = rng

    def batch(self, batch: int, seq: int) -> Dict[str, np.ndarray]:
        u = self.rng.random((batch, seq))
        toks = np.empty((batch, seq + 1), np.int64)
        toks[:, 0] = self.rng.integers(0, self.eff, batch)
        for t in range(seq):
            toks[:, t + 1] = (self.cum[toks[:, t]] < u[:, t][:, None]).sum(axis=1)
        mapped = self.id_map[toks]
        return {"tokens": mapped[:, :-1].astype(np.int32),
                "labels": mapped[:, 1:].astype(np.int32)}

    def stream(self, batch: int, seq: int) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            yield self.batch(batch, seq)
