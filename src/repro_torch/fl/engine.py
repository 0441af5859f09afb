"""The FL round loop: local-train -> uplink -> aggregate -> downlink.

Port of ``repro.fl.engine``: an :class:`EngineSpec` (uplink, downlink,
aggregator, block allocation, EF sync period) run by :class:`FLEngine` on
the host path -- a Python loop over rounds whose work runs on the task's
device.  The engine owns what every scheme shares: the shared-randomness
key schedule, the block-allocation control plane, the channels' explicit
state carry, the periodic error-feedback sync (CSER / LIEC), BitMeter
accounting, the cohort schedule and the evaluation history.  Under partial
participation (``EngineSpec.participation`` < 1, the PR variants only)
each round trains and transmits a cohort drawn by
:meth:`FLEngine.cohort_schedule`; the other clients keep their estimates.

The block plan is a host-side numpy decision each round, as in the
reference: an adaptive allocation reads the round's KL statistic
(``_kl_stats``), which costs one device-to-host copy per round.

Not ported yet, and refused with ``NotImplementedError``: the fused
whole-run path (``mode="fused"``), the wire audit, fault injection,
and checkpoint/resume.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch import prng
from repro_torch.core import mrc
from repro_torch.core.bernoulli import bern_kl, clip01
from repro_torch.core.bitmeter import BitMeter
from repro_torch.kernels import ops
from .channels import BlockPlan, RoundContext, ServerUpdate, TAG_COHORT, TAG_TRAIN
from .data import Dataset


def _cohort_mean(ctx, x: torch.Tensor) -> torch.Tensor:
    """Mean over the cohort axis, rounded as the reference's ``jnp.mean``
    (fault-free rounds; the survivor-weighted form comes with faults)."""
    return mrc.sample_mean(x)


def _kl_stats(payload: torch.Tensor, priors: torch.Tensor, *,
              needs_profile: bool) -> torch.Tensor:
    """The round's KL statistic, as ``alloc.plan`` reads it: the
    per-parameter KL of the posteriors against the client priors, averaged
    over the cohort (the profile, (d,)), or its mean over parameters (0-d).

    On the card it goes through the CUDA ``bernoulli_kl`` kernel: the
    profile (``ops.bernoulli_kl_profile``) when the allocation needs it,
    else the mean KL ``ops.bernoulli_kl_total / d``.  On the CPU it is the
    reference host loop's statistic, ``mean(bern_kl(payload, clip01(priors)),
    axis=0)`` rounded as XLA rounds a mean, whatever ``needs_profile`` says:
    it is what the reference feeds every adaptive allocation there.  The two
    routes agree up to float32 rounding (the kernel's log/log1p form and
    another summation order).
    """
    p = clip01(priors)
    if payload.device.type == "cuda":
        if needs_profile:
            return ops.bernoulli_kl_profile(payload, p)
        return ops.bernoulli_kl_total(payload, p) / payload.shape[-1]
    return mrc.sample_mean(bern_kl(payload, p))


class MeanModelAggregator:
    """BiCompFL: the mean of the conveyed posterior samples *is* the model."""

    def __call__(self, ctx, theta, up_out) -> ServerUpdate:
        return ServerUpdate(theta=_cohort_mean(ctx, up_out))


@dataclass
class MeanDeltaAggregator:
    """Conventional FL: average the (compressed) deltas, step the server."""

    server_lr: float = 1.0

    def __call__(self, ctx, theta, up_out) -> ServerUpdate:
        g = _cohort_mean(ctx, up_out)
        return ServerUpdate(theta=theta - self.server_lr * g, delta=g, lr=self.server_lr)


@dataclass
class EngineSpec:
    """A complete FL scheme: who compresses what, in which direction."""

    uplink: Any
    downlink: Any
    aggregator: Any
    allocation: Any = None       # block-allocation strategy (MRC schemes)
    participation: float = 1.0   # fraction of clients active per round
    sync_period: int = 0         # 0 = never; else flush EF memories every k
    name: str = ""


class FLEngine:
    """Runs an :class:`EngineSpec` against a task and sharded dataset."""

    def __init__(self, task, spec: EngineSpec):
        self.task = task
        self.spec = spec

    @staticmethod
    def cohort_schedule(rounds: int, n: int, n_active: int, seed: int,
                        cohort_rng: str = "numpy") -> np.ndarray:
        """The (rounds, n_active) table of each round's sorted cohort ids.

        ``numpy`` consumes ``default_rng(seed + 17)``, one sorted draw
        without replacement per round, in round order; ``jax`` derives
        round t's cohort from the shared key, ``prng.choice(fold_in(
        round_key(PRNGKey(seed), t), TAG_COHORT), n, (n_active,),
        replace=False)``, sorted.  Both are the reference's, draw for draw.
        The table is host data, computed on the CPU.
        """
        if cohort_rng not in ("numpy", "jax"):
            raise ValueError(cohort_rng)
        if n_active >= n:
            return np.tile(np.arange(n, dtype=np.int64), (rounds, 1))
        if cohort_rng == "numpy":
            rng = np.random.default_rng(seed + 17)
            return np.stack([np.sort(rng.choice(n, size=n_active, replace=False))
                             for _ in range(rounds)])
        base = prng.PRNGKey(seed, device="cpu")
        kc = prng.fold_in(mrc.round_key(base, torch.arange(rounds)), TAG_COHORT)
        return torch.sort(prng.choice(kc, n, (n_active,), replace=False),
                          dim=-1).values.numpy()

    def run(self, shards: Dataset, theta0: Optional[torch.Tensor] = None, *,
            rounds: int, seed: int = 0, eval_every: int = 1, mode: str = "auto",
            cohort_rng: str = "numpy", wire: Optional[str] = None, faults=None,
            checkpoint_dir: Optional[str] = None, checkpoint_every: int = 0,
            resume_from: Optional[str] = None) -> Dict[str, Any]:
        """Run the scheme on the host path (``mode`` "auto" or "host").

        Returns the reference's result dict (``history``, ``meter``,
        ``theta``, ``theta_hat``, ``final_acc``, ``max_acc``,
        ``active_schedule``, ``mode``) plus ``phase_seconds``: per round,
        host-clock seconds of each phase (``train``, ``codec`` = uplink +
        aggregate + downlink, ``eval``; 0.0 where no eval ran), each ended
        by a device synchronise.
        """
        if mode == "fused":
            raise NotImplementedError("mode='fused' (one captured whole-run "
                                      "program) is not ported yet")
        if mode not in ("auto", "host"):
            raise ValueError(mode)
        if cohort_rng not in ("numpy", "jax"):
            raise ValueError(cohort_rng)
        for name, value in (("wire", wire), ("faults", faults),
                            ("checkpoint_dir", checkpoint_dir),
                            ("checkpoint_every", checkpoint_every),
                            ("resume_from", resume_from)):
            if value:
                raise NotImplementedError(f"{name}= is not ported yet")
        task, spec = self.task, self.spec
        alloc = spec.allocation

        n = int(shards.y.shape[0])
        theta = task.init_theta() if theta0 is None else theta0
        d = int(theta.shape[0])
        device = theta.device
        theta_hat = theta[None].repeat(n, 1)
        meter = BitMeter(n_clients=n, d=d, broadcast_downlink_shareable=getattr(
            spec.downlink, "broadcast_shareable", True))
        n_active = max(1, int(round(spec.participation * n)))
        schedule = self.cohort_schedule(rounds, n, n_active, seed, cohort_rng)
        up_s = spec.uplink.init_up_state(n, d, device)
        dn_s = spec.downlink.init_down_state(n, d, device)
        base = prng.PRNGKey(seed, device=device)
        history = []
        phase = {"train": [], "codec": [], "eval": []}

        def sync():
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            return time.perf_counter()

        for t in range(rounds):
            t0 = sync()
            kt = mrc.round_key(base, t)
            active = schedule[t]
            # Keys are split over all n clients, then the cohort's taken.
            train_keys = prng.split(prng.fold_in(kt, TAG_TRAIN), n)
            if n_active < n:
                ids = torch.as_tensor(active, device=device)
                priors, xs, ys, keys = (theta_hat[ids], shards.x[ids], shards.y[ids],
                                        train_keys[ids])
            else:
                priors, xs, ys, keys = theta_hat, shards.x, shards.y, train_keys
            payload = task.local_train(priors, xs, ys, keys)
            t1 = sync()

            plan = None
            if alloc is not None:
                kl = None
                if getattr(alloc, "needs_kl", True):
                    kl = _kl_stats(payload, priors, needs_profile=getattr(
                        alloc, "needs_profile", True)).cpu().numpy()
                size, n_blocks, seg_ids, overhead = alloc.plan(kl, d)
                plan = BlockPlan(size=size, n_blocks=n_blocks, seg_ids=seg_ids,
                                 overhead_bits=overhead)
            ctx = RoundContext(t=t, key=kt, n_clients=n, d=d, active=active,
                               plan=plan)
            up_out, ul_bits, up_s = spec.uplink.step_up(ctx, up_s, payload, priors)
            update = spec.aggregator(ctx, theta, up_out)
            res, dn_s = spec.downlink.step_down(ctx, dn_s, update, theta, theta_hat)
            theta, theta_hat = res.theta, res.theta_hat
            dl_bits = res.bits
            # Periodic EF sync (CSER / LIEC): both links flush their memory
            # at the aggregator's step size; every client resyncs to theta.
            if spec.sync_period and (t + 1) % spec.sync_period == 0:
                r_up, b_up, up_s = spec.uplink.flush_step(up_s, n, d)
                r_dn, b_dn, dn_s = spec.downlink.flush_step(dn_s, n, d)
                theta = theta - update.lr * (r_up + r_dn)
                theta_hat = theta[None].repeat(n, 1)
                ul_bits += b_up
                dl_bits += b_dn
            oh = plan.overhead_bits * n if plan is not None else 0.0
            meter.add_round(ul_bits, dl_bits, overhead_bits=oh)
            t2 = sync()
            t3 = t2
            if (t + 1) % eval_every == 0 or t == rounds - 1:
                acc = task.evaluate(theta)
                history.append({"round": t + 1, "acc": acc,
                                "cum_bits": meter.total_bits,
                                "bpp_so_far": meter.total_bpp})
                t3 = sync()
            phase["train"].append(t1 - t0)
            phase["codec"].append(t2 - t1)
            phase["eval"].append(t3 - t2)

        return {"history": history, "meter": meter.summary(),
                "theta": theta, "theta_hat": theta_hat,
                "final_acc": history[-1]["acc"] if history else float("nan"),
                "max_acc": max(h["acc"] for h in history) if history
                else float("nan"),
                "active_schedule": schedule, "mode": "host",
                "phase_seconds": phase}
