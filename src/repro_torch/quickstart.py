"""Quickstart: BiCompFL-GR on a synthetic federated task (the port's copy of
``examples/quickstart.py``, same configuration).

    PYTHONPATH=src python -m repro_torch.quickstart              # on the card
    PYTHONPATH=src python -m repro_torch.quickstart --device cpu
    PYTHONPATH=src python -m repro_torch.quickstart --allocation adaptive

Ten clients train a probabilistic mask over a frozen signed-constant MLP
100->256->10 (d = 28160); all communication runs through bi-directional MRC
with 64 candidates, over blocks of 128 (``fixed``, the default), over
equal blocks re-sized each round (``adaptive-avg``) or over variable
segments of equal KL mass (``adaptive``), the paper's three allocations
(``benchmarks/run.py`` ``table_main``).  On the card the MRC importance
weights go through the hand-written CUDA kernels ``mrc_logw`` (equal
blocks) and ``segment_logw`` (segments), and the adaptive plans read the
round's KL through ``bernoulli_kl``; the engine's default (fused) path
captures a round as CUDA graphs once and replays them every round.
"""
from __future__ import annotations

import argparse
import time

from repro_torch import prng, resolve_device
from repro_torch.core.blocks import (AdaptiveAllocation, AdaptiveAvgAllocation,
                                     FixedAllocation)
from repro_torch.fl.data import make_synthetic, partition_iid
from repro_torch.fl.engine import FLEngine
from repro_torch.fl.nets import make_mlp
from repro_torch.fl.registry import bicompfl_spec
from repro_torch.fl.tasks import make_mask_task

CONFIG = dict(n_train=2000, n_test=500, hw=10, noise=0.4, n_clients=10,
              widths=(256,), local_epochs=3, lr=0.1, block_size=128, n_is=64,
              rounds=15, eval_every=3, seed=0, allocation="fixed")
ALLOCATIONS = ("fixed", "adaptive-avg", "adaptive")


def make_allocation(c):
    """The configuration's block allocation (``c["allocation"]``)."""
    name = c["allocation"]
    if name == "fixed":
        return FixedAllocation(c["block_size"])
    if name == "adaptive-avg":
        return AdaptiveAvgAllocation(n_is=c["n_is"])
    if name == "adaptive":
        return AdaptiveAllocation(n_is=c["n_is"])
    raise ValueError(f"allocation {name!r} is not one of {ALLOCATIONS}")


def build(device="cuda", cfg=None):
    """The quickstart's (task, spec, shards) on ``device``."""
    c = dict(CONFIG, **(cfg or {}))
    dev = resolve_device(device)
    key = prng.PRNGKey(0, device=dev)
    train, test = make_synthetic(key, n_train=c["n_train"], n_test=c["n_test"],
                                 hw=c["hw"], noise=c["noise"], device=dev)
    n = c["n_clients"]
    shards = partition_iid(prng.fold_in(key, 1), train, n, c["n_train"] // n)
    net = make_mlp(in_dim=c["hw"] * c["hw"], widths=c["widths"],
                   signed_constant=True, device=dev)
    task = make_mask_task(net, prng.fold_in(key, 2), test.x, test.y,
                          local_epochs=c["local_epochs"], lr=c["lr"])
    # GR: MRC uplink over shared candidates + index-relay downlink (which
    # relays the uplink indices, so the reference's n_dl=n_clients is unread).
    spec = bicompfl_spec("GR", allocation=make_allocation(c), n_is=c["n_is"])
    return task, spec, shards


def run(device="cuda", rounds=None, eval_every=None, cfg=None):
    """Build and run the quickstart; returns the engine's result dict."""
    c = dict(CONFIG, **(cfg or {}))
    task, spec, shards = build(device, c)
    return FLEngine(task, spec).run(
        shards, rounds=rounds or c["rounds"], seed=c["seed"],
        eval_every=eval_every or c["eval_every"])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--rounds", type=int, default=CONFIG["rounds"])
    ap.add_argument("--allocation", choices=ALLOCATIONS, default=CONFIG["allocation"])
    args = ap.parse_args(argv)
    t0 = time.time()
    out = run(args.device, rounds=args.rounds, cfg={"allocation": args.allocation})
    print(f"model dimension d = {out['theta'].shape[0]} Bernoulli parameters")
    for h in out["history"]:
        print(f"round {h['round']:3d}  acc {h['acc']:.3f}  "
              f"cumulative bpp {h['bpp_so_far']:.4f}")
    m = out["meter"]
    print(f"\nfinal acc {out['final_acc']:.3f}   max acc {out['max_acc']:.3f}")
    print(f"bitrate: {m['bpp']:.4f} bpp (vs 64 bpp dense FedAvg -> "
          f"{64 / m['bpp']:.0f}x reduction)   [{time.time() - t0:.0f}s]")


if __name__ == "__main__":
    main()
