"""End-to-end example: train a ~100M-parameter qwen3-family model (port of
``examples/train_100m.py``).

    PYTHONPATH=src python -m repro_torch.train_100m [--steps 300] [--bicompfl] \
        [--ckpt run.ckpt] [--device cpu]

The production stack: the config system, ``launch.train.Trainer``, the
synthetic Markov token pipeline (``data.batches_for``) and, with
``--ckpt``, the checkpoint of the trained tree.  ``--bicompfl`` turns on
the paper's stochastic-sign gradient compression inside the train step.

~100M config: 12 layers, d_model 768, 12 heads (GQA kv=4), d_ff 2048,
vocab 8192 => ~98M parameters, f32.
"""
from __future__ import annotations

import argparse
import time
from typing import Callable, List, Optional, Tuple

from repro_torch.data import batches_for
from repro_torch.launch.train import Trainer
from repro_torch.models.config import ArchConfig

CFG_100M = ArchConfig(
    name="repro-100m", arch_type="dense",
    n_layers=12, d_model=768, n_heads=12, n_kv_heads=4,
    d_ff=2048, vocab=8192, head_dim=64,
    qk_norm=True, dtype="float32", remat=False,
    source="examples/train_100m.py (qwen3-family, scaled)",
)


def run(*, steps: int = 300, batch: int = 8, seq: int = 256, lr: float = 3e-4,
        bicompfl: bool = False, device="cuda",
        log: Optional[Callable[[str], None]] = print) -> Tuple[Trainer, List[float]]:
    """Train ``CFG_100M`` for ``steps`` steps: the trainer and each step's loss."""
    trainer = Trainer(CFG_100M, lr=lr, microbatches=1, kv_chunk=seq,
                      grad_compression="stochastic_sign" if bicompfl else None,
                      device=device)
    t0 = time.time()
    losses = []
    for step, b in enumerate(batches_for(CFG_100M, batch, seq, seed=0, n=steps)):
        losses.append(trainer.step(b))
        if log and (step % 20 == 0 or step == steps - 1):
            tok_s = (step + 1) * batch * seq / (time.time() - t0)
            log(f"step {step:4d}  loss {losses[-1]:8.4f}  ({tok_s:,.0f} tok/s)")
    return trainer, losses


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--bicompfl", action="store_true",
                    help="stochastic-sign gradient compression")
    ap.add_argument("--ckpt", default=None, help="save the trained tree here")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    print(f"arch {CFG_100M.name}: {CFG_100M.params_count()/1e6:.0f}M params, "
          f"vocab {CFG_100M.vocab}")
    t0 = time.time()
    trainer, losses = run(steps=args.steps, batch=args.batch, seq=args.seq, lr=args.lr,
                          bicompfl=args.bicompfl, device=args.device)
    if not losses[-1] < losses[0]:
        raise SystemExit(f"loss did not decrease: {losses[0]:.4f} -> {losses[-1]:.4f}")
    if args.ckpt:
        from repro_torch import checkpoint
        checkpoint.save(args.ckpt, trainer.params, step=args.steps)
        print(f"saved checkpoint to {args.ckpt}")
    print(f"loss {losses[0]:.3f} -> {losses[-1]:.3f} over {args.steps} steps "
          f"in {time.time()-t0:.0f}s")
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
