"""The FL round loop: local-train -> uplink -> aggregate -> downlink.

Port of ``repro.fl.engine``: an :class:`EngineSpec` (uplink, downlink,
aggregator, block allocation, EF sync period) run by :class:`FLEngine`.
The engine owns what every scheme shares: the shared-randomness key
schedule, the block-allocation control plane, the channels' explicit state
carry, the periodic error-feedback sync (CSER / LIEC), BitMeter
accounting, the cohort schedule and the evaluation history, fault
injection and crash-safe resume.  Under partial participation
(``EngineSpec.participation`` < 1, the PR variants only) each round trains
and transmits a cohort drawn by :meth:`FLEngine.cohort_schedule`; the
other clients keep their estimates.

Two execution paths, chosen as the reference chooses them (``mode``
"auto" runs fused wherever :meth:`FLEngine.fused_supported` holds and no
wire audit is asked for):

* **host** -- a Python loop over rounds whose work runs on the task's
  device.  An adaptive allocation recomputes its *exact* plan each round
  on the host from the round's KL statistic (``_kl_stats``, one
  device-to-host copy a round).  Functional channels run the step
  functions with an explicit state carry; ``wire="audit"`` runs (and
  channels without the step protocol) take the eager shell protocol
  (``_shell_round``): every payload is serialized through
  :mod:`repro_torch.wire` and decoded back, the decoded values drive the
  round, and the session reconciles against the BitMeter.
* **fused** -- the counterpart of the reference's one ``lax.scan``: the
  round's functions run on static device buffers (the carry: theta,
  theta_hat and the channel states; the shards; the round index, cohort
  and base key; under faults the round's fault masks), captured once per
  run signature as CUDA graphs on the card and replayed every round; on
  the CPU the same functions run eagerly in the same order.  Static plans
  replay a train graph (local training) and a codec graph (uplink,
  aggregate, downlink, which reads the train graph's results from static
  buffers) every round, an eval graph on eval rounds and a flush graph on
  sync rounds; their bits are booked from the Python floats the first
  round records.  Adaptive allocations run *bucketed* plans
  (``core.blocks``' bucket API): a stats graph trains and selects the
  bucket on the device, the host reads the bucket index (one 4-byte read
  a round, in place of ``lax.switch``) and replays that bucket's graph,
  captured on its first selection; the round's bits ride out in float32
  device vectors.

Fault injection (DESIGN.md §8): ``run(..., faults=FaultPlan(...))``
precomputes the whole fault trajectory next to the cohort schedule; both
paths consume the same tables (the host loop as Python values, the fused
path as device buffers its graphs read), so the same seed gives the
identical faulted run in either mode.  Dropped / lost clients keep their
error-feedback rows and ``theta_hat`` rows (``torch.where``), surviving
contributions are renormalised through ``RoundContext.up_weight``, an
all-fail round keeps the pre-round carry (compute-then-discard select),
and corrupted deliveries book their wasted copies into the BitMeter's
``retransmit_bits`` -- on the wire-audit path as real flipped frame copies
that must fail their CRC.

Both paths mark their phases as :mod:`repro_torch.spans` (``fl.job``,
``fl.round`` and, inside it, ``fl.train``, ``fl.codec``, ``fl.eval``,
``fl.flush``, ``fl.book``), which record only under a profiler or
``spans.recording()``.

Crash-safe resume: ``checkpoint_dir=`` + ``checkpoint_every=`` write the
full engine carry (model, per-client estimates, channel states, BitMeter,
history and a config blob) through the atomic :mod:`repro_torch.checkpoint`
writer, in the reference's layout, at the reference's round boundaries;
``resume_from=`` restores it (the port's file or the reference's) and
continues bit-identically.  The fused path saves between replays, and a
resumed fused run starts its program's round counter at the saved round.
"""
from __future__ import annotations

import gc
import json
import os
import weakref
from dataclasses import asdict, dataclass
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch import checkpoint as ckpt
from repro_torch import prng, spans
from repro_torch.core import mrc
from repro_torch.core.bernoulli import bern_kl, clip01
from repro_torch.core.bitmeter import BitMeter
from repro_torch.kernels import ops
from repro_torch.tree import tree_map
from .channels import BlockPlan, RoundContext, ServerUpdate, TAG_COHORT, TAG_TRAIN
from .data import Dataset
from .faults import FaultPlan, corrupt_copy, fault_report


def _cohort_mean(ctx, x: torch.Tensor) -> torch.Tensor:
    """Mean over the cohort axis, renormalised over survivors under faults.

    On fault-free rounds ``ctx.up_weight`` is None and this is the
    reference's ``jnp.mean``, rounded as XLA rounds it (``mrc.sample_mean``).
    Under injected faults the weights zero out dropped / straggling /
    lost-uplink rows and the denominator is the survivor count (guarded
    against the all-fail round, whose result the engine discards): the
    reference's ``tensordot(w, x, axes=1) / den``, its rows added one after
    another onto a zero accumulator as XLA's dot adds them.
    """
    w = getattr(ctx, "up_weight", None)
    if w is None:
        return mrc.sample_mean(x)
    tot = w.sum()
    den = torch.where(tot > 0.0, tot, torch.ones_like(tot))
    acc = torch.zeros_like(x[0])
    for i in range(x.shape[0]):
        acc = acc + w[i] * x[i]
    return acc / den


def _carry_rows(prev, new, keep: torch.Tensor):
    """Keep per-client state rows only where ``keep`` (an (n,) bool tensor);
    carry ``prev`` rows.  Leaves whose leading axis is the client axis are
    row-masked, everything else (server-side state) takes the new value;
    a missing ``prev`` (a shell channel before its first round) is zeros."""
    if new is None:
        return None
    n = keep.shape[0]
    if prev is None:
        prev = tree_map(torch.zeros_like, new)

    def sel(p, q):
        if isinstance(q, torch.Tensor) and q.dim() >= 1 and q.shape[0] == n:
            return torch.where(keep.reshape((n,) + (1,) * (q.dim() - 1)), q, p)
        return q

    return tree_map(sel, prev, new)


def _faulted_round_bits(ul_bits, dl_bits, oh_full, rf, n_active, dl_denom):
    """Scale one round's nominal bit totals by its fault view.

    Returns ``(uplink, downlink, overhead, retransmit)`` bits.  Uplink
    bills every *delivered* sender (stragglers included -- the traffic
    happened); each corrupted copy re-bills one per-client payload into the
    retransmit category; the downlink of an all-fail round never leaves
    the server; CTRL side information reaches online clients only.  The
    host loop and the fused path's booking run the same float arithmetic.
    """
    per_up = ul_bits / n_active
    per_dn = dl_bits / dl_denom if dl_denom else 0.0
    per_oh = oh_full / len(rf.online)
    ul = per_up * float(rf.delivered_up.sum())
    rt = per_up * float(rf.up_wasted.sum())
    if rf.all_failed:
        dl = 0.0
    else:
        dl = per_dn * float(rf.delivered_dn.sum())
        rt += per_dn * float(rf.dn_wasted.sum())
    oh = per_oh * float(rf.online.sum())
    return ul, dl, oh, rt


def _kl_stats(payload: torch.Tensor, priors: torch.Tensor, *,
              needs_profile: bool) -> Dict[str, Any]:
    """The round's KL statistics, ``{"profile", "total"}``, without leaving
    the device: the per-parameter KL of the posteriors against the client
    priors, averaged over the cohort (the profile, (d,)), and its sum.

    On the card it goes through the CUDA ``bernoulli_kl`` kernel: the
    profile (``ops.bernoulli_kl_profile``) and its sum when the allocation
    needs the profile, else only the kernel's total
    (``ops.bernoulli_kl_total``; the profile is None).  On the CPU it is the
    reference host loop's profile, ``mean(bern_kl(payload, clip01(priors)),
    axis=0)`` rounded as XLA rounds a mean, whatever ``needs_profile`` says:
    it is what the reference's host loop feeds every adaptive allocation
    there.  The two routes agree up to float32 rounding (the kernel's
    log/log1p form and another summation order).  The total is torch's sum,
    not XLA's order: a bucket reads it only through a ceil or a round, so it
    may pick another bucket than the reference only within an ulp of a
    bucket edge (``test_torch_fused.py`` counts such rounds).
    """
    p = clip01(priors)
    if payload.device.type == "cuda" and not needs_profile:
        return {"profile": None, "total": ops.bernoulli_kl_total(payload, p)}
    if payload.device.type == "cuda":
        klp = ops.bernoulli_kl_profile(payload, p)
    else:
        klp = mrc.sample_mean(bern_kl(payload, p))
    return {"profile": klp, "total": klp.sum()}


def _copy_tree_(dst, src) -> None:
    """Copy a channel state (a tensor, or nested tuples of tensors; ``()``
    for a stateless channel) into the static buffers of the same structure."""
    if isinstance(dst, torch.Tensor):
        dst.copy_(src)
    elif isinstance(dst, (tuple, list)):
        for a, b in zip(dst, src):
            _copy_tree_(a, b)


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
        # Fused programs, one per run signature (rounds, shapes, dtypes,
        # device): seed replicates and new datasets of the same shapes reuse
        # the captured graphs.  ``fused_capture_count`` counts the round
        # functions captured (on the CPU: first run in a program, where the
        # card would capture); ``fused_replay_count`` the replays.
        self._fused_programs: Dict[Any, _FusedProgram] = {}
        self.fused_capture_count = 0
        self.fused_replay_count = 0

    # -- fused-path eligibility -------------------------------------------

    def _functional_channels(self) -> bool:
        """Both channels speak the pure-state protocol (explicit carry)."""
        spec = self.spec
        up_ok = all(hasattr(spec.uplink, a)
                    for a in ("step_up", "init_up_state", "flush_step"))
        dn_ok = all(hasattr(spec.downlink, a)
                    for a in ("step_down", "init_down_state", "flush_step"))
        return up_ok and dn_ok

    def fused_supported(self) -> bool:
        """True when the whole run can take the fused path.

        Only non-functional channels force the host loop, and an allocation
        exposing neither a static plan nor the bucket API, or a
        data-dependent plan combined with a periodic EF flush (a pairing no
        registry scheme produces), as in the reference.
        """
        spec = self.spec
        if spec.allocation is not None and \
                not getattr(spec.allocation, "static_plan", False):
            bucket_ok = all(hasattr(spec.allocation, a) for a in
                            ("bucket_plans", "select_bucket", "finalize_plan"))
            if not bucket_ok or spec.sync_period:
                return False
        return self._functional_channels()

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

    # -- the round pieces both paths run ----------------------------------

    def _train(self, kt, theta_hat, x, y, ids):
        """Local training of the cohort: (payload, priors).  Keys are split
        over all n clients, then the cohort's taken (``ids`` a device index
        tensor, or None for the full cohort)."""
        train_keys = prng.split(prng.fold_in(kt, TAG_TRAIN), theta_hat.shape[0])
        if ids is not None:
            priors, xs, ys, keys = theta_hat[ids], x[ids], y[ids], train_keys[ids]
        else:
            priors, xs, ys, keys = theta_hat, x, y, train_keys
        return self.task.local_train(priors, xs, ys, keys), priors

    def _round_core(self, plan, theta, theta_hat, up_s, dn_s, payload, priors, ctx):
        """Uplink -> aggregate -> downlink at one plan; returns (theta,
        theta_hat, up_s, dn_s, update, uplink bits, downlink bits,
        overhead bits)."""
        spec = self.spec
        up_out, ul_bits, up_s = spec.uplink.step_up(ctx, up_s, payload, priors)
        update = spec.aggregator(ctx, theta, up_out)
        res, dn_s = spec.downlink.step_down(ctx, dn_s, update, theta, theta_hat)
        oh = plan.overhead_bits * ctx.n_clients if plan is not None else 0.0
        return res.theta, res.theta_hat, up_s, dn_s, update, ul_bits, res.bits, oh

    def _flush(self, theta, up_s, dn_s, lr, n, d):
        """Periodic EF sync (CSER / LIEC): both links flush their memory at
        the aggregator's step size; every client resyncs to theta.  Returns
        (theta, theta_hat, up_s, dn_s, uplink bits, downlink bits)."""
        spec = self.spec
        r_up, b_up, up_s = spec.uplink.flush_step(up_s, n, d)
        r_dn, b_dn, dn_s = spec.downlink.flush_step(dn_s, n, d)
        theta = theta - lr * (r_up + r_dn)
        return theta, theta[None].repeat(n, 1), up_s, dn_s, b_up, b_dn

    # -- entry point -------------------------------------------------------

    def run(self, shards: Dataset, theta0: Optional[torch.Tensor] = None, *,
            rounds: int, seed: int = 0, eval_every: int = 1, mode: str = "auto",
            cohort_rng: str = "numpy", wire: Optional[str] = None,
            faults: Optional[FaultPlan] = None,
            checkpoint_dir: Optional[str] = None, checkpoint_every: int = 0,
            resume_from: Optional[str] = None) -> Dict[str, Any]:
        """Run the scheme.  ``mode``: "auto" (fused when eligible), "host",
        or "fused" (raises ``ValueError`` for a spec that needs the host
        control plane).

        ``wire="audit"`` serializes every channel payload through the
        :mod:`repro_torch.wire` bitstream each round (encode -> decode; the
        decoded values drive the trajectory) and reconciles the BitMeter
        against the stream; host path only.  The report lands in
        ``out["wire"]`` and the stream in ``out["wire_session"]``.

        ``faults=FaultPlan(...)`` injects the plan's deterministic fault
        schedule (dropouts, stragglers, frame corruption); the event log and
        summary land in ``out["faults"]``.  A plan that draws no fault for
        this run leaves the trajectory bit-identical to ``faults=None``.

        ``checkpoint_dir=`` (+ ``checkpoint_every=k``) saves the full engine
        state every k rounds (and at the end); ``resume_from=`` (a
        checkpoint file, or a directory to scan for the newest valid step)
        restores it and continues bit-identically.

        Returns the reference's result dict (``history``, ``meter``,
        ``theta``, ``theta_hat``, ``final_acc``, ``max_acc``,
        ``active_schedule``, ``mode``, and the keys above).  The fused path
        under an adaptive allocation adds ``buckets``, the bucket index of
        every round it ran.  The job's rounds are the span ``fl.job``.
        """
        task, spec = self.task, self.spec
        if wire not in (None, "audit"):
            raise ValueError(f"wire={wire!r} (expected None or 'audit')")
        if wire and mode == "fused":
            raise ValueError("wire audit runs on the host path; it cannot "
                             "be combined with mode='fused'")
        if faults is not None and not isinstance(faults, FaultPlan):
            raise ValueError(f"faults={faults!r} (expected a FaultPlan)")
        if checkpoint_every and not checkpoint_dir:
            raise ValueError("checkpoint_every needs checkpoint_dir")
        if checkpoint_every < 0:
            raise ValueError(f"checkpoint_every={checkpoint_every} < 0")
        if wire and (checkpoint_dir or resume_from):
            raise ValueError("wire audit cannot checkpoint or resume (the "
                             "session stream is not part of the saved carry)")
        if (checkpoint_dir or resume_from) and not self._functional_channels():
            raise ValueError(
                f"spec {spec.name!r} cannot checkpoint/resume: channels "
                "without the pure-state protocol have no explicit carry")
        # Stateful shells (error-feedback memories) must start fresh: a spec
        # may be run more than once.
        for chan in (spec.uplink, spec.downlink):
            reset = getattr(chan, "reset", None)
            if reset is not None:
                reset()
        n = int(shards.y.shape[0])
        theta = task.init_theta() if theta0 is None else theta0
        d = int(theta.shape[0])
        theta_hat = theta[None].repeat(n, 1)
        meter = BitMeter(n_clients=n, d=d, broadcast_downlink_shareable=getattr(
            spec.downlink, "broadcast_shareable", True))
        n_active = max(1, int(round(spec.participation * n)))
        schedule = self.cohort_schedule(rounds, n, n_active, seed, cohort_rng)

        # The fault schedule, precomputed like the cohort schedule; ``views``
        # stays None when the drawn schedule is fault-free, which keeps the
        # run on the fault-free code paths.
        fsched = views_all = views = None
        if faults is not None:
            fsched = faults.schedule(rounds, n)
            dl_rec = getattr(spec.downlink, "downlink_recipients", "all")
            views_all = fsched.run_views(schedule, dl_rec)
            if any(v.faulty or v.all_failed for v in views_all):
                views = views_all
        if views is not None and not wire and not self._functional_channels():
            raise ValueError(
                f"spec {spec.name!r} cannot run under faults without the "
                "pure-state channel protocol (state rows must be carried "
                "explicitly) or a wire session")
        if views is not None and wire:
            for role, chan in (("uplink", spec.uplink), ("downlink", spec.downlink)):
                if not (hasattr(chan, "export_state") and hasattr(chan, "import_state")):
                    raise ValueError(
                        f"spec {spec.name!r} cannot run faulted wire audit: "
                        f"{role} channel lacks export_state/import_state")

        if mode not in ("auto", "host", "fused"):
            raise ValueError(mode)
        fused_ok = self.fused_supported()
        if mode == "fused" and not fused_ok:
            raise ValueError(
                f"spec {spec.name!r} needs the host control plane "
                "(non-functional channels, an allocation without the bucket "
                "API, or a data-dependent plan combined with an EF flush)")
        fused = fused_ok and mode != "host" and not wire

        cfg_blob = None
        if checkpoint_dir or resume_from:
            cfg_blob = self._config_blob(rounds=rounds, seed=seed, eval_every=eval_every,
                                         cohort_rng=cohort_rng, n=n, d=d, faults=faults)
        start_round, carry_in, history0 = 0, None, None
        if resume_from:
            start_round, theta, theta_hat, carry_in, history0 = self._load_resume(
                resume_from, cfg_blob, meter, theta.device)

        run_kw = dict(rounds=rounds, seed=seed, eval_every=eval_every, schedule=schedule,
                      views=views, start_round=start_round, carry_in=carry_in,
                      history=history0, checkpoint_dir=checkpoint_dir,
                      checkpoint_every=checkpoint_every, cfg_blob=cfg_blob)
        session = None
        if wire:
            from repro_torch.wire import WireSession, scheme_wire_id
            session = WireSession(scheme_id=scheme_wire_id(spec.name or "unnamed"))
        with spans.span("fl.job", theta.device):
            if fused:
                out = self._run_fused(shards, theta, theta_hat, meter, **run_kw)
            else:
                out = self._run_host(shards, theta, theta_hat, meter, session=session,
                                     fsched=fsched, **run_kw)
        if session is not None:
            out["wire"] = session.reconcile(meter)
            out["wire_session"] = session
        out["active_schedule"] = schedule
        out["mode"] = "fused" if fused else "host"
        if faults is not None:
            rt_by_round = [h.get("retransmit_bits", 0.0) for h in meter.history]
            out["faults"] = fault_report(faults, views_all, rt_by_round)
        return out

    # -- checkpoint / resume ------------------------------------------------

    def _config_blob(self, *, rounds, seed, eval_every, cohort_rng, n, d,
                     faults) -> np.ndarray:
        """Run configuration as a uint8 JSON blob (a checkpoint leaf), the
        reference's byte for byte.  Compared bytewise on resume: a
        checkpoint only resumes the *same* run (spec, rounds, seed, fault
        plan), because everything the engine recomputes from scratch --
        cohort schedule, fault schedule, round keys -- must re-derive
        identically for the continuation to be bit-exact."""
        spec = self.spec
        cfg = {
            "kind": "fl-engine-checkpoint",
            "format": 1,
            "spec": spec.name,
            "rounds": int(rounds),
            "seed": int(seed),
            "eval_every": int(eval_every),
            "cohort_rng": cohort_rng,
            "n": int(n),
            "d": int(d),
            "participation": float(spec.participation),
            "sync_period": int(spec.sync_period),
            "faults": None if faults is None else asdict(faults),
        }
        raw = json.dumps(cfg, sort_keys=True).encode("utf-8")
        return np.frombuffer(raw, np.uint8).copy()

    def _save_state(self, directory, next_round, theta, theta_hat, up_s, dn_s, meter,
                    history, cfg_blob) -> None:
        """Write the full engine carry as one atomic per-step checkpoint, in
        the reference's tree layout (channel states as their tensors, or
        ``()`` for a stateless channel)."""
        mh = meter.history
        host = lambda t: t.detach().cpu().numpy()  # noqa: E731
        state = {
            "config": cfg_blob,
            "next_round": np.int64(next_round),
            "theta": host(theta),
            "theta_hat": host(theta_hat),
            "up_state": tree_map(host, up_s),
            "dn_state": tree_map(host, dn_s),
            "meter": {
                "uplink_bits": np.float64(meter.uplink_bits),
                "downlink_bits": np.float64(meter.downlink_bits),
                "retransmit_bits": np.float64(meter.retransmit_bits),
                "rounds": np.int64(meter.rounds),
                "hist_round": np.asarray([h["round"] for h in mh], np.int64),
                "hist_up": np.asarray([h["uplink_bits"] for h in mh], np.float64),
                "hist_dn": np.asarray([h["downlink_bits"] for h in mh], np.float64),
                "hist_rt": np.asarray([h.get("retransmit_bits", 0.0) for h in mh],
                                      np.float64),
                "hist_cum": np.asarray([h["cum_bits"] for h in mh], np.float64),
            },
            "history": {
                "round": np.asarray([h["round"] for h in history], np.int64),
                "acc": np.asarray([h["acc"] for h in history], np.float64),
                "cum_bits": np.asarray([h["cum_bits"] for h in history], np.float64),
                "bpp": np.asarray([h["bpp_so_far"] for h in history], np.float64),
            },
        }
        ckpt.save_step(directory, state, int(next_round))

    def _load_resume(self, resume_from, cfg_blob, meter, device):
        """Restore ``(start_round, theta, theta_hat, carry, history)``, the
        tensors on ``device``.

        ``resume_from`` is a checkpoint file, or a directory whose newest
        *valid* step checkpoint is chosen (torn files are skipped with a
        warning by :func:`repro_torch.checkpoint.latest`).  The saved config
        blob must match this run's exactly.
        """
        if os.path.isdir(resume_from):
            path, _ = ckpt.latest(resume_from)
            if path is None:
                raise ValueError(f"resume_from={resume_from!r}: no valid checkpoint found")
        else:
            path = resume_from
        state, _ = ckpt.load(path)
        if bytes(np.asarray(state["config"], np.uint8)) != bytes(np.asarray(cfg_blob, np.uint8)):
            raise ValueError(
                f"checkpoint {path} was saved by a different run configuration "
                "(spec/rounds/seed/faults must be identical to resume)")
        m = state["meter"]
        meter.uplink_bits = float(m["uplink_bits"])
        meter.downlink_bits = float(m["downlink_bits"])
        meter.retransmit_bits = float(m["retransmit_bits"])
        meter.rounds = int(m["rounds"])
        meter.history = []
        for r, u, dl, rt, cum in zip(m["hist_round"], m["hist_up"], m["hist_dn"],
                                     m["hist_rt"], m["hist_cum"]):
            entry = {"round": int(r), "uplink_bits": float(u),
                     "downlink_bits": float(dl), "cum_bits": float(cum)}
            if rt:  # key present only when nonzero, as add_round writes it
                entry["retransmit_bits"] = float(rt)
            meter.history.append(entry)
        h = state["history"]
        history0 = [{"round": int(r), "acc": float(a), "cum_bits": float(c),
                     "bpp_so_far": float(b)}
                    for r, a, c, b in zip(h["round"], h["acc"], h["cum_bits"], h["bpp"])]
        dev = lambda a: torch.from_numpy(np.array(a)).to(device)  # noqa: E731
        carry = (tree_map(dev, state["up_state"]), tree_map(dev, state["dn_state"]))
        return (int(np.asarray(state["next_round"])), dev(state["theta"]),
                dev(state["theta_hat"]), carry, history0)

    # -- host loop ---------------------------------------------------------

    def _run_host(self, shards, theta, theta_hat, meter, *, rounds, seed, eval_every,
                  schedule, session=None, views=None, fsched=None, start_round=0,
                  carry_in=None, history=None, checkpoint_dir=None, checkpoint_every=0,
                  cfg_blob=None) -> Dict[str, Any]:
        task, spec = self.task, self.spec
        alloc = spec.allocation
        n, d = meter.n_clients, meter.d
        n_active = schedule.shape[1]
        device = theta.device
        base = prng.PRNGKey(seed, device=device)
        history = list(history) if history else []
        faulted = views is not None
        dl_rec = getattr(spec.downlink, "downlink_recipients", "all")
        dl_denom = n if dl_rec == "all" else n_active
        if session is not None:
            self._check_wire_support()
        # Functional channels carry their state explicitly (fault masks
        # applied between rounds); the wire audit and non-functional
        # channels take the eager shell protocol.
        staged = session is None and self._functional_channels()
        up_s = dn_s = None
        if staged:
            if carry_in is not None:
                up_s, dn_s = carry_in
            else:
                up_s = spec.uplink.init_up_state(n, d, device)
                dn_s = spec.downlink.init_down_state(n, d, device)
        on_dev = lambda a: torch.as_tensor(a, device=device)  # noqa: E731

        for t in range(start_round, rounds):
            active = schedule[t]
            rf = views[t] if faulted else None
            msgs = []  # this round's wire traffic (audit mode only)
            with spans.span("fl.round", device):
                with spans.span("fl.train", device):
                    kt = mrc.round_key(base, t)
                    ids = on_dev(active) if n_active < n else None
                    payload, priors = self._train(kt, theta_hat, shards.x, shards.y, ids)

                with spans.span("fl.codec", device):
                    plan = None
                    if alloc is not None:
                        kl = None
                        if getattr(alloc, "needs_kl", True):
                            stats = _kl_stats(payload, priors, needs_profile=getattr(
                                alloc, "needs_profile", True))
                            # The profile, or the mean KL where the card took only the total.
                            kl = (stats["total"] / d if stats["profile"] is None
                                  else stats["profile"]).cpu().numpy()
                        size, n_blocks, seg_ids, overhead = alloc.plan(kl, d)
                        plan = BlockPlan(size=size, n_blocks=n_blocks, seg_ids=seg_ids,
                                         overhead_bits=overhead)
                        if session is not None:
                            # The plan crosses the wire as one CTRL frame per client
                            # (the meter books overhead_bits * n); the decoded plan --
                            # not the host object -- drives the round.  Under faults
                            # the CTRL link is protected signalling: never corrupted,
                            # but dropped clients miss their copy.
                            ctrl = self._encode_plan_msgs(plan, n)
                            plan = self._decode_plan_msg(ctrl[0], d)
                            msgs += [m for m in ctrl if not faulted or rf.online[m.sender]]

                    if staged:
                        ctx = RoundContext(t=t, key=kt, n_clients=n, d=d, active=active, plan=plan,
                                           up_weight=on_dev(rf.up_weight) if faulted else None)
                        th, thh, us, ds, update, ul_bits, dl_bits, oh_full = self._round_core(
                            plan, theta, theta_hat, up_s, dn_s, payload, priors, ctx)
                        if faulted:
                            # Carried, not corrupted: dropped/lost rows keep their
                            # pre-round EF state and theta_hat estimate; an all-fail
                            # round discards the whole computed step.
                            us = _carry_rows(up_s, us, on_dev(rf.delivered_up))
                            thh = torch.where(on_dev(rf.delivered_dn)[:, None], thh, theta_hat)
                            if rf.all_failed:
                                th, thh, us, ds = theta, theta_hat, up_s, dn_s
                            ul_r, dl_r, oh_r, rt_r = _faulted_round_bits(
                                ul_bits, dl_bits, oh_full, rf, n_active, dl_denom)
                        else:
                            ul_r, dl_r, oh_r, rt_r = ul_bits, dl_bits, oh_full, 0.0
                        theta, theta_hat, up_s, dn_s = th, thh, us, ds
                        # The EF sync is protected signalling: exempt from faults,
                        # booked unscaled.
                        if spec.sync_period and (t + 1) % spec.sync_period == 0:
                            theta, theta_hat, up_s, dn_s, b_up, b_dn = self._flush(
                                theta, up_s, dn_s, update.lr, n, d)
                            ul_r += b_up
                            dl_r += b_dn
                        meter.add_round(ul_r, dl_r, overhead_bits=oh_r, retransmit_bits=rt_r)
                    else:
                        theta, theta_hat = self._shell_round(
                            t, kt, active, plan, payload, priors, theta, theta_hat, meter,
                            session, msgs, rf, fsched, n, d, n_active, dl_denom)
                    if session is not None:
                        session.add(msgs, round=t)
                if (t + 1) % eval_every == 0 or t == rounds - 1:
                    with spans.span("fl.eval", device):
                        acc = task.evaluate(theta)
                        history.append({"round": t + 1, "acc": acc,
                                        "cum_bits": meter.total_bits,
                                        "bpp_so_far": meter.total_bpp})
                if staged and checkpoint_dir and (
                        (checkpoint_every and (t + 1) % checkpoint_every == 0) or t + 1 == rounds):
                    self._save_state(checkpoint_dir, t + 1, theta, theta_hat, up_s, dn_s, meter,
                                     history, cfg_blob)

        return self._result(history, meter, theta, theta_hat)

    def _shell_round(self, t, kt, active, plan, payload, priors, theta, theta_hat, meter,
                     session, msgs, rf, fsched, n, d, n_active, dl_denom):
        """One eager shell-protocol round (wire audit / non-functional).

        Appends this round's frames to ``msgs`` (mutated in place) and books
        the meter.  ``rf`` is the round's fault view or None; a faulted
        shell round always has a wire session (enforced in ``run``), injects
        real corrupted frame copies, and books bits from the stream itself
        so the session reconciles exactly.
        """
        spec = self.spec
        device = theta.device
        on_dev = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
        faulted = rf is not None
        if faulted:
            up_snap = spec.uplink.export_state()
            dn_snap = spec.downlink.export_state()
            n_wasted0 = len(session.wasted)
        ctx = RoundContext(t=t, key=kt, n_clients=n, d=d, active=active, plan=plan,
                           up_weight=on_dev(rf.up_weight) if faulted else None)

        # ---- uplink -> aggregate -> downlink -------------------------------
        if session is None:
            up_out, ul_bits = spec.uplink.transmit(ctx, payload, priors)
        else:
            up_out, ul_bits, up_msgs = spec.uplink.transmit_wire(ctx, payload, priors)
            up_out = spec.uplink.decode_up(ctx, up_msgs, priors)
            if faulted:
                spec.uplink.import_state(_carry_rows(
                    up_snap, spec.uplink.export_state(), on_dev(rf.delivered_up)))
                msgs += self._wire_deliver(
                    session, fsched, rf, t, up_msgs, owner="sender", link=0,
                    sched=rf.senders, ok=rf.delivered_up, wasted=rf.up_wasted)
            else:
                msgs += up_msgs
        update = spec.aggregator(ctx, theta, up_out)
        if session is None:
            theta, theta_hat, dl_bits = spec.downlink.distribute(ctx, update, theta, theta_hat)
        elif faulted and rf.all_failed:
            # Compute-then-discard: the server aborts before broadcasting,
            # every client (and the channel state) keeps its pre-round view;
            # only the uplink traffic that did happen is billed.
            spec.uplink.import_state(up_snap)
            spec.downlink.import_state(dn_snap)
            dl_bits = 0.0
        else:
            from .channels import WireEnv
            _, dn_msgs = spec.downlink.distribute_wire(ctx, update, theta, theta_hat, up_msgs)
            env = WireEnv(uplink=spec.uplink, aggregator=spec.aggregator, priors=priors,
                          up_msgs=up_msgs, update=update)
            new_th, new_hat, dl_bits = spec.downlink.decode_down(ctx, dn_msgs, theta,
                                                                 theta_hat, env)
            if faulted:
                theta = new_th
                theta_hat = torch.where(on_dev(rf.delivered_dn)[:, None], new_hat, theta_hat)
                msgs += self._wire_deliver(
                    session, fsched, rf, t, dn_msgs, owner="recipient", link=1,
                    sched=rf.nominal_recv & rf.online, ok=rf.delivered_dn,
                    wasted=rf.dn_wasted)
            else:
                theta, theta_hat = new_th, new_hat
                msgs += dn_msgs

        # ---- periodic EF synchronisation (CSER / LIEC) ---------------------
        if spec.sync_period and (t + 1) % spec.sync_period == 0:
            if session is None:
                r_up, b_up = spec.uplink.flush(n, d)
            else:
                r_up, b_up, fl_msgs = spec.uplink.flush_wire(n, d)
                if fl_msgs:
                    r_up = spec.uplink.decode_flush_up(fl_msgs, n, d).to(device)
                msgs += fl_msgs
            r_dn, b_dn = spec.downlink.flush(n, d)
            # flush at the aggregator's step size (update.lr), so a hand-built
            # spec cannot desync the reset from the rounds
            theta = theta - update.lr * (r_up + r_dn)
            theta_hat = theta[None].repeat(n, 1)
            ul_bits += b_up
            dl_bits += b_dn
            if session is not None and b_dn:
                # The downlink flush re-broadcasts the synced model: n dense
                # frames of the post-flush theta, n * d * 32 bits == every
                # stateful downlink's booked flush cost.  The decoded
                # broadcast drives the trajectory.
                fd_msgs, theta = self._flush_down_msgs(theta, n, d, b_dn)
                theta_hat = theta[None].repeat(n, 1)
                msgs += fd_msgs

        if faulted:
            # Book straight from the frames that actually hit the stream
            # (CTRL overhead rides the uplink direction), so the session
            # reconcile is exact by construction.
            from repro_torch.wire import DOWNLINK_DIRS, UPLINK_DIRS
            ul_r = float(sum(m.payload_bits for m in msgs if m.direction in UPLINK_DIRS))
            dl_r = float(sum(m.payload_bits for m in msgs if m.direction in DOWNLINK_DIRS))
            rt_r = float(sum(wa.payload_bits for wa in session.wasted[n_wasted0:]))
            meter.add_round(ul_r, dl_r, retransmit_bits=rt_r)
        else:
            overhead_bits = plan.overhead_bits * n if plan is not None else 0.0
            meter.add_round(ul_bits, dl_bits, overhead_bits=overhead_bits)
        return theta, theta_hat

    def _wire_deliver(self, session, fsched, rf, t, msgs, *, owner, link, sched, ok, wasted):
        """Route one direction's frames through the faulty link.

        For every scheduled frame, materialize each corrupted copy the fault
        schedule drew (flip the scheduled bit, *prove* the CRC rejects it,
        book it as a wasted attempt), then deliver the clean frame iff the
        retry budget survived.  Returns the delivered frames.
        """
        from repro_torch.wire import Message, WireError
        delivered = []
        for m in msgs:
            cid = getattr(m, owner)
            if not sched[cid]:
                continue
            for a in range(int(wasted[cid])):
                stamped = Message(direction=m.direction, sender=m.sender,
                                  recipient=m.recipient, payload=m.payload,
                                  payload_bits=m.payload_bits, round=t,
                                  scheme_id=session.scheme_id)
                raw = stamped.to_bytes()
                bit = fsched.flip_bit(t, cid, link, a, 8 * len(raw))
                try:
                    Message.from_bytes(corrupt_copy(raw, bit))
                except WireError:
                    pass
                else:
                    raise AssertionError(
                        f"corrupted frame copy (round {t}, client {cid}, bit {bit}) "
                        "parsed cleanly: the CRC failed to catch the flip")
                session.add_wasted(stamped, round=t, attempt=a, flipped_bit=bit)
            if ok[cid]:
                delivered.append(m)
        return delivered

    # -- wire-audit helpers ------------------------------------------------

    def _check_wire_support(self) -> None:
        spec = self.spec
        missing = [a for a in ("transmit_wire", "decode_up") if not hasattr(spec.uplink, a)]
        missing += [a for a in ("distribute_wire", "decode_down")
                    if not hasattr(spec.downlink, a)]
        if spec.allocation is not None and not all(
                hasattr(spec.allocation, a) for a in ("encode_plan", "decode_plan")):
            missing.append("allocation.encode_plan/decode_plan")
        if missing:
            raise ValueError(f"spec {spec.name!r} cannot be wire-audited: missing {missing}")
        # Fail before any round work: a non-power-of-two n_is books
        # fractional bits per index and would only surface as a
        # WireCapacityError from codecs.index_width mid-run.
        from repro_torch.wire.codecs import WireCapacityError, index_width
        for role, chan in (("uplink", spec.uplink), ("downlink", spec.downlink)):
            n_is = getattr(chan, "n_is", None)
            if n_is is None:
                continue
            try:
                index_width(n_is)
            except WireCapacityError as e:
                raise ValueError(
                    f"spec {spec.name!r} cannot be wire-audited: {role} channel "
                    f"{type(chan).__name__} has n_is={n_is}, which books fractional "
                    "bits per MRC index; wire codecs need a power of two") from e

    def _encode_plan_msgs(self, plan, n):
        from repro_torch.wire import DIR_CTRL, SERVER, BitWriter, Message
        w = BitWriter()
        self.spec.allocation.encode_plan(plan, w)
        payload, nbits = w.getvalue(), w.bits_written
        return [Message(direction=DIR_CTRL, sender=cid, recipient=SERVER, payload=payload,
                        payload_bits=nbits) for cid in range(n)]

    def _decode_plan_msg(self, msg, d):
        from repro_torch.wire import BitReader
        r = BitReader(msg.payload, msg.payload_bits)
        plan = self.spec.allocation.decode_plan(r, d)
        r.expect_exhausted()
        return plan

    def _flush_down_msgs(self, theta, n, d, b_dn):
        from repro_torch.wire import DIR_FLUSH_DOWN, SERVER, BitReader, BitWriter, Message
        from repro_torch.wire import codecs as wcodecs
        if b_dn != n * d * 32:
            raise ValueError(
                f"downlink flush books {b_dn} bits; the wire layer only knows the "
                f"dense re-broadcast protocol ({n * d * 32} bits)")
        w = BitWriter()
        wcodecs.put_dense(w, theta.detach().cpu().numpy())
        payload, nbits = w.getvalue(), w.bits_written
        msgs = [Message(direction=DIR_FLUSH_DOWN, sender=SERVER, recipient=cid,
                        payload=payload, payload_bits=nbits) for cid in range(n)]
        r = BitReader(msgs[0].payload, msgs[0].payload_bits)
        theta = torch.as_tensor(wcodecs.get_dense(r, d), device=theta.device)
        r.expect_exhausted()
        return msgs, theta

    # -- fused path --------------------------------------------------------

    def _run_fused(self, shards, theta, theta_hat, meter, *, rounds, seed, eval_every,
                   schedule, views=None, start_round=0, carry_in=None, history=None,
                   checkpoint_dir=None, checkpoint_every=0, cfg_blob=None) -> Dict[str, Any]:
        n, d = meter.n_clients, meter.d
        n_active = schedule.shape[1]
        faulted = views is not None
        eval_mask = np.zeros(rounds, bool)
        eval_mask[eval_every - 1::eval_every] = True
        if rounds:
            eval_mask[-1] = True
        flush_mask = np.zeros(rounds, bool)
        if self.spec.sync_period:
            flush_mask[self.spec.sync_period - 1::self.spec.sync_period] = True
        # Seed, cohort schedule, masks, fault tables and the data ride in as
        # buffer contents; only a shape, dtype or device change, or being
        # faulted, builds a new program.
        sig = (rounds, n, d, n_active, faulted, tuple(shards.x.shape), str(shards.x.dtype),
               tuple(shards.y.shape), str(shards.y.dtype), str(theta.dtype),
               str(theta.device))
        prog = self._fused_programs.get(sig)
        if prog is None:
            prog = self._fused_programs[sig] = _FusedProgram(
                self, rounds=rounds, n=n, d=d, n_active=n_active, shards=shards,
                theta=theta, faulted=faulted)
        return prog.run(shards, theta, theta_hat, meter, seed=seed, schedule=schedule,
                        eval_mask=eval_mask, flush_mask=flush_mask, views=views,
                        start_round=start_round, carry_in=carry_in, history=history,
                        checkpoint_dir=checkpoint_dir, checkpoint_every=checkpoint_every,
                        cfg_blob=cfg_blob)

    @staticmethod
    def _result(history, meter, theta, theta_hat) -> Dict[str, Any]:
        return {"history": history, "meter": meter.summary(),
                "theta": theta, "theta_hat": theta_hat,
                "final_acc": history[-1]["acc"] if history else float("nan"),
                "max_acc": max(h["acc"] for h in history) if history
                else float("nan")}


_CAPTURE_STREAMS: Dict[Any, Any] = {}


def _capture_stream(device: torch.device):
    """The one side stream per device on which every program warms up and
    captures: torch keeps a cuBLAS workspace (and ``bernoulli_kl`` its
    scratch) per stream, so a stream per program would hold one each."""
    stream = _CAPTURE_STREAMS.get(device)
    if stream is None:
        stream = _CAPTURE_STREAMS[device] = torch.cuda.Stream(device)
    return stream


class _FusedProgram:
    """One run signature of the fused path: static device buffers and the
    round functions that read and write them.

    On the card each function is captured once as a CUDA graph (all of a
    program's graphs in one memory pool, since they replay one after
    another) and replayed; its first call runs eagerly on a side stream
    first -- that call *is* its round's work -- so that kernel builds,
    library loads and lazy initialisations happen outside the capture.  On
    the CPU every call runs the function eagerly, in the same order.  A
    capture that fails raises: the card never falls back to the host loop.

    A faulted program's rounds also read the round's fault masks (the
    survivor weights, the uplink keep and downlink receive rows, the
    not-all-failed flag), copied from the run's tables into static buffers
    before each replay; the carry and the all-fail select are
    ``torch.where`` inside the graph.  The tables' contents are per-run
    data, so a new fault plan replays the captured graphs.
    """

    def __init__(self, engine: FLEngine, *, rounds, n, d, n_active, shards, theta,
                 faulted=False):
        spec = engine.spec
        dev = theta.device
        # A weak reference: the engine owns its programs, and a cycle would
        # keep a dropped engine's graphs alive until the collector runs.
        self.engine = weakref.proxy(engine)
        self.rounds, self.n, self.d, self.n_active = rounds, n, d, n_active
        self.full = n_active == n
        self.faulted = faulted
        self.on_card = dev.type == "cuda"
        alloc = self.alloc = spec.allocation
        self.adaptive = alloc is not None and not getattr(alloc, "static_plan", False)
        if self.adaptive:
            self.plans = alloc.bucket_plans(d)
        elif alloc is not None:
            size, n_blocks, seg_ids, overhead = alloc.plan(None, d)
            self.plans = [BlockPlan(size=size, n_blocks=n_blocks, seg_ids=seg_ids,
                                    overhead_bits=overhead)]
        else:
            self.plans = [None]
        f32, i64 = torch.float32, torch.int64
        # Per-run inputs (the reference's scan xs and runner arguments).
        self.base = torch.zeros(2, dtype=i64, device=dev)
        self.t = torch.zeros((), dtype=i64, device=dev)
        self.sched = torch.zeros((rounds, n_active), dtype=i64, device=dev)
        self.active = torch.zeros(n_active, dtype=i64, device=dev)
        self.x = torch.empty_like(shards.x, device=dev)
        self.y = torch.empty_like(shards.y, device=dev)
        if faulted:
            # The run's fault tables, and the round's rows the graphs read.
            self.tables = {"w": torch.zeros((rounds, n_active), dtype=f32, device=dev),
                           "keep_up": torch.zeros((rounds, n), dtype=torch.bool, device=dev),
                           "recv": torch.zeros((rounds, n), dtype=torch.bool, device=dev),
                           "ok": torch.zeros(rounds, dtype=torch.bool, device=dev)}
            self.masks = {k: torch.empty_like(v[0]) for k, v in self.tables.items()}
        # The carry.
        self.theta = torch.empty_like(theta)
        self.theta_hat = torch.empty((n, d), dtype=theta.dtype, device=dev)
        self.up_s = spec.uplink.init_up_state(n, d, dev)
        self.dn_s = spec.downlink.init_down_state(n, d, dev)
        # Outputs read at the checkpoint boundaries and the end: accuracy at
        # eval rounds and, under an adaptive allocation, the round's uplink,
        # downlink and overhead bits; the train or stats graph's results,
        # read by the codec or bucket graphs (a static full cohort's priors
        # are theta_hat itself).
        self.accs = torch.zeros(rounds, dtype=f32, device=dev)
        self.bits = torch.zeros((3, rounds), dtype=f32, device=dev)
        self.payload = torch.empty((n_active, d), dtype=f32, device=dev)
        self.priors = self.theta_hat if self.full and not self.adaptive else \
            torch.empty((n_active, d), dtype=f32, device=dev)
        if not self.adaptive:
            self.kt = torch.empty(2, dtype=i64, device=dev)
        else:
            self.profile = torch.empty(d, dtype=f32, device=dev)
            self.total = torch.empty((), dtype=f32, device=dev)
            self.bidx = torch.empty((), dtype=torch.int32, device=dev)
        self.booked: Dict[str, tuple] = {}   # static plans' Python-float bits
        self.graphs: Dict[Any, Any] = {}
        self.pool = None
        self.stream = _capture_stream(dev) if self.on_card else None

    # -- the round functions (captured on the card) ------------------------

    def _ctx(self, plan, kt):
        return RoundContext(t=self.t, key=kt, n_clients=self.n, d=self.d,
                            active=self.active, plan=plan,
                            up_weight=self.masks["w"] if self.faulted else None)

    def _store(self, theta, theta_hat, up_s, dn_s):
        """Write the round's carry back, under faults after the same masking
        as the host loop: theta_hat rows that missed the downlink keep the
        pre-round value, EF rows of undelivered uplinks are carried, and the
        whole step is discarded on an all-fail round."""
        if self.faulted:
            m = self.masks
            theta_hat = torch.where(m["recv"][:, None], theta_hat, self.theta_hat)
            up_s = _carry_rows(self.up_s, up_s, m["keep_up"])
            theta, theta_hat, up_s, dn_s = tree_map(
                lambda new, old: torch.where(m["ok"], new, old),
                (theta, theta_hat, up_s, dn_s),
                (self.theta, self.theta_hat, self.up_s, self.dn_s))
        _copy_tree_((self.theta, self.theta_hat, self.up_s, self.dn_s),
                    (theta, theta_hat, up_s, dn_s))

    def _train(self):
        """Static plan: the round key and local training, left in the static
        buffers the codec graph reads."""
        kt = mrc.round_key(self.base, self.t)
        payload, priors = self.engine._train(kt, self.theta_hat, self.x, self.y,
                                             None if self.full else self.active)
        self.kt.copy_(kt)
        self.payload.copy_(payload)
        if priors is not self.priors:
            self.priors.copy_(priors)

    def _codec(self):
        """Static plan: uplink, aggregate, downlink on the train graph's
        results."""
        plan = self.plans[0]
        theta, theta_hat, up_s, dn_s, update, ul, dl, oh = self.engine._round_core(
            plan, self.theta, self.theta_hat, self.up_s, self.dn_s, self.payload,
            self.priors, self._ctx(plan, self.kt))
        self._store(theta, theta_hat, up_s, dn_s)
        self.booked.setdefault("round", (ul, dl, oh, update.lr))

    def _sync(self):
        """The periodic EF flush, at the step size the round recorded.  It is
        protected signalling, never faulted."""
        *carry, b_up, b_dn = self.engine._flush(
            self.theta, self.up_s, self.dn_s, self.booked["round"][3], self.n, self.d)
        _copy_tree_((self.theta, self.theta_hat, self.up_s, self.dn_s), carry)
        self.booked.setdefault("flush", (b_up, b_dn))

    def _eval(self):
        acc = self.engine.task.accuracy(self.theta)
        self.accs.index_copy_(0, self.t.view(1), acc.to(torch.float32).reshape(1))

    def _stats(self):
        """Adaptive plans: train, the KL statistics and the bucket index."""
        kt = mrc.round_key(self.base, self.t)
        payload, priors = self.engine._train(kt, self.theta_hat, self.x, self.y,
                                             None if self.full else self.active)
        stats = _kl_stats(payload, priors, needs_profile=getattr(
            self.alloc, "needs_profile", True))
        self.payload.copy_(payload)
        self.priors.copy_(priors)
        if stats["profile"] is not None:
            self.profile.copy_(stats["profile"])
        self.total.copy_(stats["total"])
        self.bidx.copy_(self.alloc.select_bucket(stats, self.d))

    def _bucket(self, b: int):
        """Adaptive plans: bucket ``b``'s plan finalised on the device, then
        uplink, aggregate, downlink; the bits go into the device vectors."""
        stats = {"profile": self.profile, "total": self.total}
        plan = self.alloc.finalize_plan(self.plans[b], stats, self.d)
        ctx = self._ctx(plan, mrc.round_key(self.base, self.t))
        theta, theta_hat, up_s, dn_s, _, ul, dl, oh = self.engine._round_core(
            plan, self.theta, self.theta_hat, self.up_s, self.dn_s, self.payload,
            self.priors, ctx)
        self._store(theta, theta_hat, up_s, dn_s)
        at = self.t.view(1)
        for row, bits in zip(self.bits, (ul, dl, oh)):
            if isinstance(bits, torch.Tensor):
                row.index_copy_(0, at, bits.to(torch.float32).reshape(1))
            else:
                row.index_fill_(0, at, float(bits))

    # -- capture and replay -------------------------------------------------

    def _play(self, name, fn, span: str) -> None:
        """Replay graph ``name``, or run and capture ``fn`` as it, inside
        the span ``span``."""
        with spans.span(span, self.theta.device):
            graph = self.graphs.get(name)
            if graph is not None:
                self.engine.fused_replay_count += 1
                graph.replay() if self.on_card else fn()
                return
            self.engine.fused_capture_count += 1
            if not self.on_card:
                self.graphs[name] = fn
                fn()
                return
            cur = torch.cuda.current_stream(self.stream.device)
            self.stream.wait_stream(cur)
            with torch.cuda.stream(self.stream):
                fn()                      # this round's work, eagerly: the warm-up
            cur.wait_stream(self.stream)
            graph = torch.cuda.CUDAGraph()
            # No garbage collection inside the capture: destroying another
            # program's graph there would invalidate it (``torch.cuda.graph``
            # collects just before the capture begins).
            collecting = gc.isenabled()
            gc.disable()
            try:
                with torch.cuda.graph(graph, pool=self.pool, stream=self.stream):
                    fn()
            finally:
                if collecting:
                    gc.enable()
            if self.pool is None:
                self.pool = graph.pool()
            self.graphs[name] = graph

    def _book(self, meter, s, e, eval_mask, flush_mask, views, history):
        """Book rounds [s, e) into the meter and the history: static plans
        from the Python floats the first round recorded, adaptive ones from
        the device bit vectors (read here); under faults through the host
        loop's ``_faulted_round_bits``."""
        n, n_active = self.n, self.n_active
        dl_rec = getattr(self.engine.spec.downlink, "downlink_recipients", "all")
        dl_denom = n if dl_rec == "all" else n_active
        seg_eval = eval_mask[s:e]
        accs = self.accs[s:e].cpu().numpy()
        if self.adaptive:
            ul, dl, oh = self.bits[:, s:e].cpu().numpy().astype(np.float64)
            # Exact while every per-round total stays below 2**24 (integers
            # times log2 of a pow2 n_is in float32), as the reference guards.
            if max((float(np.max(np.abs(v))) if v.size else 0.0) for v in (ul, dl, oh)) \
                    >= 2.0 ** 24:
                raise OverflowError(
                    "per-round bits exceed the float32 integer-exact range (2**24); "
                    "run mode='host' for exact accounting at this scale")
            if views is not None:
                rows = [_faulted_round_bits(float(ul[i]), float(dl[i]), float(oh[i]),
                                            views[s + i], n_active, dl_denom)
                        for i in range(e - s)]
                snaps = meter.book_run([r[0] for r in rows], [r[1] for r in rows],
                                       overhead_bits=[r[2] for r in rows],
                                       retransmit_bits=[r[3] for r in rows],
                                       snapshot_mask=seg_eval)
            else:
                snaps = meter.book_run(ul, dl, overhead_bits=oh, snapshot_mask=seg_eval)
        else:
            ul, dl, oh, _ = self.booked["round"]
            fl_up, fl_dn = self.booked.get("flush", (0.0, 0.0))
            uls, dls, ohs, rts = [], [], [], []
            for t in range(s, e):
                if views is not None:
                    u_, d_, o_, r_ = _faulted_round_bits(ul, dl, oh, views[t], n_active,
                                                         dl_denom)
                else:
                    u_, d_, o_, r_ = ul, dl, oh, 0.0
                uls.append(u_ + (fl_up if flush_mask[t] else 0.0))  # flush: unscaled
                dls.append(d_ + (fl_dn if flush_mask[t] else 0.0))
                ohs.append(o_)
                rts.append(r_)
            snaps = meter.book_run(uls, dls, overhead_bits=ohs, retransmit_bits=rts,
                                   snapshot_mask=seg_eval)
        history += [{"round": s + int(i) + 1, "acc": float(accs[i]), "cum_bits": cum_bits,
                     "bpp_so_far": bpp}
                    for i, (cum_bits, bpp) in zip(np.nonzero(seg_eval)[0], snaps)]

    def run(self, shards, theta, theta_hat, meter, *, seed, schedule, eval_mask,
            flush_mask, views=None, start_round=0, carry_in=None, history=None,
            checkpoint_dir=None, checkpoint_every=0, cfg_blob=None) -> Dict[str, Any]:
        spec, n, d = self.engine.spec, self.n, self.d
        dev = self.theta.device
        history = list(history) if history else []
        if carry_in is None:
            carry_in = (spec.uplink.init_up_state(n, d, dev),
                        spec.downlink.init_down_state(n, d, dev))
        _copy_tree_((self.x, self.y, self.theta, self.theta_hat, self.up_s, self.dn_s),
                    (shards.x, shards.y, theta, theta_hat, *carry_in))
        self.base.copy_(prng.PRNGKey(seed, device=dev))
        self.sched.copy_(torch.as_tensor(schedule, dtype=torch.int64))
        if self.faulted:
            host = {"w": np.stack([v.up_weight for v in views]),
                    "keep_up": np.stack([v.delivered_up for v in views]),
                    "recv": np.stack([v.delivered_dn for v in views]),
                    "ok": np.asarray([not v.all_failed for v in views])}
            for k, table in self.tables.items():
                table.copy_(torch.as_tensor(host[k]))
        # Checkpoints fall between replays, at the reference's boundaries.
        bounds = set()
        if checkpoint_dir and checkpoint_every:
            first = ((start_round // checkpoint_every) + 1) * checkpoint_every
            bounds = set(range(first, self.rounds, checkpoint_every))
        cuts = bounds | {self.rounds}
        buckets = []
        s = start_round
        for t in range(start_round, self.rounds):
            with spans.span("fl.round", dev):
                self.t.fill_(t)
                self.active.copy_(self.sched[t])
                if self.faulted:
                    for k, mask in self.masks.items():
                        mask.copy_(self.tables[k][t])
                if self.adaptive:
                    self._play("stats", self._stats, "fl.train")
                    b = int(self.bidx)    # the round's one device-to-host read
                    buckets.append(b)
                    self._play(("bucket", b), lambda b=b: self._bucket(b), "fl.codec")
                else:
                    self._play("train", self._train, "fl.train")
                    self._play("codec", self._codec, "fl.codec")
                    if flush_mask[t]:
                        self._play("flush", self._sync, "fl.flush")
                if eval_mask[t]:
                    self._play("eval", self._eval, "fl.eval")
                if t + 1 in cuts:
                    with spans.span("fl.book", dev):
                        self._book(meter, s, t + 1, eval_mask, flush_mask, views, history)
                    s = t + 1
                    if checkpoint_dir:
                        self.engine._save_state(checkpoint_dir, s, self.theta,
                                                self.theta_hat, self.up_s, self.dn_s, meter,
                                                history, cfg_blob)
        out = self.engine._result(history, meter, self.theta.clone(), self.theta_hat.clone())
        if self.adaptive:
            out["buckets"] = buckets
        return out


def run_spec(task, spec: EngineSpec, shards: Dataset,
             theta0: Optional[torch.Tensor] = None, *, rounds: int, seed: int = 0,
             eval_every: int = 1, mode: str = "auto", cohort_rng: str = "numpy",
             **kwargs) -> Dict[str, Any]:
    """Convenience one-shot: build an engine and run it."""
    return FLEngine(task, spec).run(shards, theta0, rounds=rounds, seed=seed,
                                    eval_every=eval_every, mode=mode,
                                    cohort_rng=cohort_rng, **kwargs)
