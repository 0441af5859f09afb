"""Non-stochastic bi-directional compression baselines (port of
``repro.fl.baselines``; paper Section 4).

All baselines share one skeleton: clients compute a local delta
("gradient"), apply an uplink compressor (with error feedback where the
original scheme uses it), the federator aggregates and may compress the
downlink, and bits are booked from what is transmitted.

* fedavg        : dense 32-bit both directions.
* memsgd        : Stich et al. 2018 -- sign + EF uplink, dense downlink.
* doublesqueeze : Tang et al. 2019 -- sign + EF uplink AND downlink.
* neolithic     : Huang et al. 2022 -- doublesqueeze with 2 compression
                  passes per direction (2 bits/param).
* cser          : Xie et al. 2020 -- sign + EF uplink, dense downlink,
                  periodic error reset (``reset_period``).
* liec          : Cheng et al. 2024 -- bidirectional sign with error
                  compensation and periodic averaging (``reset_period``).
* m3            : Gruntkowska et al. 2024 -- top-k(d/n) + EF uplink; the
                  downlink sends each client a disjoint dense 1/n slice.

Each scheme is a factory in :mod:`repro_torch.fl.registry`, run by the
shared :class:`~repro_torch.fl.engine.FLEngine` in its default mode (the
fused path).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict

import torch

from .data import Dataset
from .engine import FLEngine
from .registry import ALL_BASELINES, baseline_spec  # noqa: F401  (re-export)


@dataclass
class BaselineConfig:
    scheme: str = "fedavg"
    rounds: int = 30
    server_lr: float = 1.0
    seed: int = 0
    eval_every: int = 1
    reset_period: int = 50   # CSER / LIEC periodic sync


def run_baseline(task, theta0: torch.Tensor, shards: Dataset,
                 cfg: BaselineConfig) -> Dict[str, Any]:
    """Run one baseline from ``theta0``; returns the engine's result dict."""
    n = int(shards.x.shape[0])
    d = int(theta0.shape[0])
    spec = baseline_spec(cfg.scheme, n=n, d=d, server_lr=cfg.server_lr,
                         reset_period=cfg.reset_period)
    return FLEngine(task, spec).run(shards, theta0, rounds=cfg.rounds, seed=cfg.seed,
                                    eval_every=cfg.eval_every)
