"""BiCompFL-GR-CFL: the paper's technique in conventional FL (the port's copy
of ``examples/cfl_gradient_compression.py``, same configuration).

    PYTHONPATH=src python -m repro_torch.cfl_gradient_compression             # on the card
    PYTHONPATH=src python -m repro_torch.cfl_gradient_compression --device cpu --rounds 3

Ten clients of 200 samples train a dense MLP 100->256->10 (Kaiming normal
weights, d = 28160) for 5 local epochs of Adam (batch 32, lr 3e-3); each
quantizes its weight delta with stochastic SignSGD and conveys samples
through MRC (256 candidates, blocks of 16) against the uninformative
Ber(1/2) prior; the federator relays the indices on the downlink (global
shared randomness).  Compared side by side with DoubleSqueeze and dense
FedAvg at equal round counts.  On the card the MRC importance weights go
through the hand-written CUDA kernel ``mrc_logw``, once per round.
"""
from __future__ import annotations

import argparse
import time

from repro_torch import prng, resolve_device
from repro_torch.fl.baselines import BaselineConfig, run_baseline
from repro_torch.fl.data import make_synthetic, partition_iid
from repro_torch.fl.federator import CFLConfig, run_bicompfl_cfl
from repro_torch.fl.nets import make_mlp
from repro_torch.fl.tasks import make_cfl_task

CONFIG = dict(n_train=2000, n_test=500, hw=10, noise=0.4, n_clients=10, shard=200,
              widths=(256,), local_epochs=5, batch_size=32, local_lr=3e-3,
              server_lr=1.0, rounds=12, seed=0)
BASELINES = ("doublesqueeze", "fedavg")


def build(device="cuda"):
    """The example's (task, theta0, shards) on ``device``."""
    c = CONFIG
    dev = resolve_device(device)
    key = prng.PRNGKey(0, device=dev)
    train, test = make_synthetic(key, n_train=c["n_train"], n_test=c["n_test"],
                                 hw=c["hw"], noise=c["noise"], device=dev)
    shards = partition_iid(prng.fold_in(key, 1), train, c["n_clients"], c["shard"])
    net = make_mlp(in_dim=c["hw"] * c["hw"], widths=c["widths"], device=dev)
    task, theta0 = make_cfl_task(net, prng.fold_in(key, 2), test.x, test.y,
                                 local_epochs=c["local_epochs"],
                                 batch_size=c["batch_size"], local_lr=c["local_lr"])
    return task, theta0, shards


def run(device="cuda", rounds=CONFIG["rounds"]):
    """Run CFL and the baselines from one (task, theta0, shards); returns
    ``{scheme: (engine result dict, seconds)}``."""
    c = CONFIG
    task, theta0, shards = build(device)
    out = {}
    for scheme in ("cfl",) + BASELINES:
        t0 = time.time()
        if scheme == "cfl":
            res = run_bicompfl_cfl(task, theta0, shards, CFLConfig(
                rounds=rounds, server_lr=c["server_lr"], seed=c["seed"]))
        else:
            res = run_baseline(task, theta0, shards, BaselineConfig(
                scheme=scheme, rounds=rounds, server_lr=c["server_lr"], seed=c["seed"]))
        out[scheme] = (res, time.time() - t0)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--rounds", type=int, default=CONFIG["rounds"])
    args = ap.parse_args(argv)
    for scheme, (res, secs) in run(args.device, rounds=args.rounds).items():
        m = res["meter"]
        name = "BiCompFL-GR-CFL" if scheme == "cfl" else scheme
        print(f"{name:15s} : acc {res['max_acc']:.3f}  bpp {m['bpp']:.6f}  "
              f"(uplink {m['uplink_bpp']:.6f}, downlink {m['downlink_bpp']:.6f}, "
              f"bc {m['bpp_bc']:.6f}; {m['total_bits']:.0f} bits)  [{secs:.0f}s]")


if __name__ == "__main__":
    main()
