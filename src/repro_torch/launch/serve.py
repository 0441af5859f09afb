"""Batched serving loop with a static KV cache (port of ``repro.launch.serve``).

``Server`` drives ``transformer.serve_step`` on a random model (or on loaded
weights).  As in the reference, prompts are left-padded with token 0 (no
pad mask) and run as teacher-forced decode steps, so ``generate`` runs
neither the flash-attention nor the RWKV kernel: ``transformer.prefill_step``
is the token-parallel prefill that does.  Sampling is greedy at
temperature 0, else the Gumbel-max sample with the reference's key
schedule (``fold_in(PRNGKey(seed), 7)``, one ``split`` per step), so the
port draws the reference's tokens.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np
import torch

from repro_torch import prng, resolve_device
from repro_torch.models import transformer as T
from repro_torch.models.config import ArchConfig


@dataclass
class Request:
    prompt: np.ndarray            # (prompt_len,) int32
    max_new_tokens: int = 16
    temperature: float = 0.0      # 0 => greedy


class Server:
    def __init__(self, cfg: ArchConfig, *, max_batch: int = 8, max_seq: int = 256,
                 seed: int = 0, device="cuda"):
        if not cfg.supports_decode:
            raise ValueError(f"{cfg.name}: encoder-only archs cannot be served")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = T.build(cfg)
        self.max_batch, self.max_seq = max_batch, max_seq
        self.params = T.init_params(self.model, seed, self.device)
        self.key = prng.fold_in(prng.PRNGKey(seed, device=self.device), 7)

    def load_params(self, params):
        self.params = params

    def _sample(self, logits: torch.Tensor, temperature: float) -> torch.Tensor:
        lf = logits[:, -1].to(torch.float32)
        if temperature <= 0.0:
            return torch.argmax(lf, dim=-1)
        keys = prng.split(self.key, 2)
        self.key, k = keys[0], keys[1]
        return prng.categorical(k, lf / temperature, axis=-1)

    def generate(self, requests: List[Request]) -> List[np.ndarray]:
        """Batched generation: one shared cache, per-request lengths."""
        if len(requests) > self.max_batch:
            raise ValueError(f"{len(requests)} requests > max_batch {self.max_batch}")
        b = len(requests)
        cache = T.init_cache(self.model, b, self.max_seq, self.device)
        max_prompt = max(len(r.prompt) for r in requests)
        max_new = max(r.max_new_tokens for r in requests)

        toks = np.zeros((b, max_prompt), np.int64)
        for i, r in enumerate(requests):
            toks[i, max_prompt - len(r.prompt):] = r.prompt  # left-pad
        toks = torch.from_numpy(toks).to(self.device)
        temperature = max(r.temperature for r in requests)
        outs = [[] for _ in range(b)]
        last = None
        for t in range(max_prompt + max_new - 1):
            cur = toks[:, t:t + 1] if t < max_prompt else last
            logits, cache = T.serve_step(self.model, self.params, cache, cur, t)
            nxt = self._sample(logits, temperature)
            last = nxt[:, None]
            if t >= max_prompt - 1:
                arr = nxt.cpu().numpy()
                for i, r in enumerate(requests):
                    if len(outs[i]) < r.max_new_tokens:
                        outs[i].append(int(arr[i]))
        return [np.asarray(o, np.int32) for o in outs]
