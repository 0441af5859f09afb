"""BiCompFL federator entry point (port of ``repro.fl.federator``; paper
Algorithms 1 & 2 and their variants).

Variants (``BiCompFLConfig.variant``):

* ``GR``          -- Alg. 1: global shared randomness; the federator relays
                     the clients' MRC indices, every client reconstructs the
                     identical global model.
* ``GR-Reconst``  -- the federator reconstructs the global model and
                     re-transmits it by a second MRC round on common
                     candidates (all clients hold equal estimates).
* ``PR``          -- Alg. 2: private shared randomness only; per-client MRC
                     on the downlink; clients hold distinct estimates, and
                     a round may run on a partial cohort.
* ``PR-SplitDL``  -- PR, but each client receives only a disjoint 1/n of
                     the blocks (downlink cost / n).

``run_bicompfl_cfl`` runs BiCompFL-GR-CFL, the paper's technique in
conventional FL (stochastic sign + MRC against the Ber(1/2) prior).

Both build the scheme from the registry and run the shared
:class:`~repro_torch.fl.engine.FLEngine` on the task's device in its
default mode, "auto": the fused path, as the reference's entry points run.
The reference's ``chunk`` (a memory knob of its ``vmap``) and ``logw_fn``
are left out: the port encodes a batch whole, through the fused encoder
``ops.mrc_fixed_encode``.  So is ``CFLConfig.temperature``, which the
reference never reads (K is always each client's mean |delta|).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional

import torch

from repro_torch.core.blocks import FixedAllocation
from . import registry
from .data import Dataset
from .engine import FLEngine


@dataclass
class BiCompFLConfig:
    variant: str = "GR"          # GR | GR-Reconst | PR | PR-SplitDL
    allocation: Any = field(default_factory=lambda: FixedAllocation(256))
    n_is: int = 256
    n_ul: int = 1
    n_dl: Optional[int] = None   # default: n_clients * n_ul (paper)
    rounds: int = 30
    seed: int = 0
    eval_every: int = 1
    participation: float = 1.0   # fraction of clients per round; < 1 only
                                 # with the PR variant


def run_bicompfl(task, shards: Dataset, cfg: BiCompFLConfig) -> Dict[str, Any]:
    """Run probabilistic-mask BiCompFL; returns the engine's result dict
    (history, bit accounting, ``theta``, ``theta_hat``, ...)."""
    n = int(shards.x.shape[0])
    n_dl = cfg.n_dl if cfg.n_dl is not None else n * cfg.n_ul
    spec = registry.bicompfl_spec(
        cfg.variant, allocation=cfg.allocation, n_is=cfg.n_is, n_ul=cfg.n_ul,
        n_dl=n_dl, participation=cfg.participation)
    return FLEngine(task, spec).run(shards, rounds=cfg.rounds, seed=cfg.seed,
                                    eval_every=cfg.eval_every)


@dataclass
class CFLConfig:
    # CFL compression is near-element-wise (paper Sec. 4): a *small* block
    # keeps the per-block d_KL(q || 1/2) within the log(n_is) MRC budget --
    # stochastic-sign posteriors sit far from the uninformative prior.
    n_is: int = 256
    n_ul: int = 1
    block_size: int = 16
    rounds: int = 30
    server_lr: float = 1.0
    seed: int = 0
    eval_every: int = 1


def run_bicompfl_cfl(task, theta0: torch.Tensor, shards: Dataset,
                     cfg: CFLConfig) -> Dict[str, Any]:
    """BiCompFL-GR applied to conventional FL with stochastic SignSGD.

    Clients quantize their local delta with q = sigmoid(delta / K), convey
    samples through MRC against the uninformative prior p = 1/2, the
    federator averages the reconstructed directions (2*q_hat - 1)*K and
    steps; the downlink relays the indices (global randomness), so the
    clients track the identical global model.
    """
    spec = registry.cfl_spec(n_is=cfg.n_is, n_ul=cfg.n_ul, block_size=cfg.block_size,
                             server_lr=cfg.server_lr)
    return FLEngine(task, spec).run(shards, theta0, rounds=cfg.rounds, seed=cfg.seed,
                                    eval_every=cfg.eval_every)
