"""Batched serving example: prefill-free decode with a KV cache (port of
``examples/serve_decode.py``).

    PYTHONPATH=src python -m repro_torch.serve_decode [--arch qwen3-1.7b] [--device cpu]

Instantiates the reduced variant of an assigned architecture and serves a
batch of randomly tokenized requests through ``launch.serve.Server``, the
same ``serve_step`` the dry run traces at full scale.  It runs on the card
unless given ``--device cpu``.
"""
from __future__ import annotations

import argparse
import time
from typing import List

import numpy as np

import repro_torch.configs as C
from repro_torch.launch.serve import Request, Server


def main(argv=None) -> List[np.ndarray]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b", choices=list(C.ALIASES))
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--new-tokens", type=int, default=24)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = C.get(args.arch).reduced()
    if not cfg.supports_decode:
        raise SystemExit(f"{args.arch} is encoder-only: no decode step")
    print(f"serving reduced {cfg.name}: {cfg.n_layers}L d={cfg.d_model} "
          f"vocab={cfg.vocab} on {args.device}")

    server = Server(cfg, max_batch=args.batch, max_seq=128, device=args.device)
    rng = np.random.default_rng(0)
    reqs = [Request(prompt=rng.integers(0, cfg.vocab, size=rng.integers(4, 12)),
                    max_new_tokens=args.new_tokens, temperature=0.8)
            for _ in range(args.batch)]

    t0 = time.time()
    outs = server.generate(reqs)
    dt = time.time() - t0
    total_new = sum(len(o) for o in outs)
    for i, o in enumerate(outs):
        print(f"req {i}: prompt_len={len(reqs[i].prompt)}  -> {o[:12]}...")
    print(f"{total_new} tokens in {dt:.1f}s  ({total_new/dt:.1f} tok/s, "
          f"{args.device}, reduced config)")
    return outs


if __name__ == "__main__":
    main()
