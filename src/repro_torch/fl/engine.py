"""The FL round loop: local-train -> uplink -> aggregate -> downlink.

Port of ``repro.fl.engine``: an :class:`EngineSpec` (uplink, downlink,
aggregator, block allocation, EF sync period) run by :class:`FLEngine`.
The engine owns what every scheme shares: the shared-randomness key
schedule, the block-allocation control plane, the channels' explicit state
carry, the periodic error-feedback sync (CSER / LIEC), BitMeter
accounting, the cohort schedule and the evaluation history.  Under partial
participation (``EngineSpec.participation`` < 1, the PR variants only)
each round trains and transmits a cohort drawn by
:meth:`FLEngine.cohort_schedule`; the other clients keep their estimates.

Two execution paths, chosen as the reference chooses them (``mode``
"auto" runs fused wherever :meth:`FLEngine.fused_supported` holds):

* **host** -- a Python loop over rounds whose work runs on the task's
  device.  An adaptive allocation recomputes its *exact* plan each round
  on the host from the round's KL statistic (``_kl_stats``, one
  device-to-host copy a round).
* **fused** -- the counterpart of the reference's one ``lax.scan``: the
  round's functions run on static device buffers (the carry: theta,
  theta_hat and the channel states; the shards; the round index, cohort
  and base key), captured once per run signature as CUDA graphs on the
  card and replayed every round; on the CPU the same functions run
  eagerly in the same order.  Static plans replay one round graph, an
  eval graph on eval rounds and a flush graph on sync rounds; their bits
  are booked after the run from the Python floats the first round
  records, with no device-to-host read before the end.  Adaptive
  allocations run *bucketed* plans (``core.blocks``' bucket API): a stats
  graph trains and selects the bucket on the device, the host reads the
  bucket index (one 4-byte read a round, in place of ``lax.switch``) and
  replays that bucket's graph, captured on its first selection; the
  round's bits ride out in float32 device vectors.

Not ported yet, and refused with ``NotImplementedError``: the wire audit,
fault injection, and checkpoint/resume.
"""
from __future__ import annotations

import gc
import time
import weakref
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
        # card would capture), the counterpart of the reference's
        # ``fused_trace_count``; ``fused_replay_count`` the replays.
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
            cohort_rng: str = "numpy", wire: Optional[str] = None, faults=None,
            checkpoint_dir: Optional[str] = None, checkpoint_every: int = 0,
            resume_from: Optional[str] = None) -> Dict[str, Any]:
        """Run the scheme.  ``mode``: "auto" (fused when eligible), "host",
        or "fused" (raises ``ValueError`` for a spec that needs the host
        control plane).

        Returns the reference's result dict (``history``, ``meter``,
        ``theta``, ``theta_hat``, ``final_acc``, ``max_acc``,
        ``active_schedule``, ``mode``).  The host path adds
        ``phase_seconds``: per round, host-clock seconds of each phase
        (``train``, ``codec`` = uplink + aggregate + downlink, ``eval``; 0.0
        where no eval ran), each ended by a device synchronise.  The fused
        path under an adaptive allocation adds ``buckets``, the bucket index
        of every round.
        """
        if mode not in ("auto", "host", "fused"):
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
        fused_ok = self.fused_supported()
        if mode == "fused" and not fused_ok:
            raise ValueError(
                f"spec {spec.name!r} needs the host control plane "
                "(non-functional channels, an allocation without the bucket "
                "API, or a data-dependent plan combined with an EF flush)")

        n = int(shards.y.shape[0])
        theta = task.init_theta() if theta0 is None else theta0
        d = int(theta.shape[0])
        theta_hat = theta[None].repeat(n, 1)
        meter = BitMeter(n_clients=n, d=d, broadcast_downlink_shareable=getattr(
            spec.downlink, "broadcast_shareable", True))
        n_active = max(1, int(round(spec.participation * n)))
        schedule = self.cohort_schedule(rounds, n, n_active, seed, cohort_rng)
        if fused_ok and mode != "host":
            out = self._run_fused(shards, theta, theta_hat, meter, rounds=rounds,
                                  seed=seed, eval_every=eval_every, schedule=schedule)
        else:
            out = self._run_host(shards, theta, theta_hat, meter, rounds=rounds,
                                 seed=seed, eval_every=eval_every, schedule=schedule)
        out["active_schedule"] = schedule
        return out

    # -- host loop ---------------------------------------------------------

    def _run_host(self, shards, theta, theta_hat, meter, *, rounds, seed,
                  eval_every, schedule) -> Dict[str, Any]:
        task, spec = self.task, self.spec
        alloc = spec.allocation
        n, d = meter.n_clients, meter.d
        n_active = schedule.shape[1]
        device = theta.device
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
            ids = torch.as_tensor(active, device=device) if n_active < n else None
            payload, priors = self._train(kt, theta_hat, shards.x, shards.y, ids)
            t1 = sync()

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
            ctx = RoundContext(t=t, key=kt, n_clients=n, d=d, active=active,
                               plan=plan)
            theta, theta_hat, up_s, dn_s, update, ul_bits, dl_bits, oh = \
                self._round_core(plan, theta, theta_hat, up_s, dn_s, payload,
                                 priors, ctx)
            if spec.sync_period and (t + 1) % spec.sync_period == 0:
                theta, theta_hat, up_s, dn_s, b_up, b_dn = self._flush(
                    theta, up_s, dn_s, update.lr, n, d)
                ul_bits += b_up
                dl_bits += b_dn
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

        out = self._result(history, meter, theta, theta_hat)
        out.update(mode="host", phase_seconds=phase)
        return out

    # -- fused path --------------------------------------------------------

    def _run_fused(self, shards, theta, theta_hat, meter, *, rounds, seed,
                   eval_every, schedule) -> Dict[str, Any]:
        n, d = meter.n_clients, meter.d
        n_active = schedule.shape[1]
        eval_mask = np.zeros(rounds, bool)
        eval_mask[eval_every - 1::eval_every] = True
        if rounds:
            eval_mask[-1] = True
        flush_mask = np.zeros(rounds, bool)
        if self.spec.sync_period:
            flush_mask[self.spec.sync_period - 1::self.spec.sync_period] = True
        # Seed, cohort schedule, masks and the data ride in as buffer
        # contents; only a shape, dtype or device change builds a new program.
        sig = (rounds, n, d, n_active, tuple(shards.x.shape), str(shards.x.dtype),
               tuple(shards.y.shape), str(shards.y.dtype), str(theta.dtype),
               str(theta.device))
        prog = self._fused_programs.get(sig)
        if prog is None:
            prog = self._fused_programs[sig] = _FusedProgram(
                self, rounds=rounds, n=n, d=d, n_active=n_active, shards=shards,
                theta=theta)
        out = prog.run(shards, theta, theta_hat, meter, seed=seed, schedule=schedule,
                       eval_mask=eval_mask, flush_mask=flush_mask)
        out["mode"] = "fused"
        return out

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
    """

    def __init__(self, engine: FLEngine, *, rounds, n, d, n_active, shards, theta):
        spec = engine.spec
        dev = theta.device
        # A weak reference: the engine owns its programs, and a cycle would
        # keep a dropped engine's graphs alive until the collector runs.
        self.engine = weakref.proxy(engine)
        self.rounds, self.n, self.d = rounds, n, d
        self.full = n_active == n
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
        # The carry.
        self.theta = torch.empty_like(theta)
        self.theta_hat = torch.empty((n, d), dtype=theta.dtype, device=dev)
        self.up_s = spec.uplink.init_up_state(n, d, dev)
        self.dn_s = spec.downlink.init_down_state(n, d, dev)
        # Outputs read once at the end: accuracy at eval rounds and, under
        # an adaptive allocation, the round's uplink, downlink and overhead
        # bits; the stats graph's results, read by the bucket graphs.
        self.accs = torch.zeros(rounds, dtype=f32, device=dev)
        self.bits = torch.zeros((3, rounds), dtype=f32, device=dev)
        if self.adaptive:
            self.payload = torch.empty((n_active, d), dtype=f32, device=dev)
            self.priors = torch.empty((n_active, d), dtype=f32, device=dev)
            self.profile = torch.empty(d, dtype=f32, device=dev)
            self.total = torch.empty((), dtype=f32, device=dev)
            self.bidx = torch.empty((), dtype=torch.int32, device=dev)
        self.booked: Dict[str, tuple] = {}   # static plans' Python-float bits
        self.graphs: Dict[Any, Any] = {}
        self.pool = None
        self.stream = _capture_stream(dev) if self.on_card else None

    # -- the round functions (captured on the card) ------------------------

    def _key_and_ctx(self, plan):
        kt = mrc.round_key(self.base, self.t)
        return kt, RoundContext(t=self.t, key=kt, n_clients=self.n, d=self.d,
                                active=self.active, plan=plan)

    def _store(self, theta, theta_hat, up_s, dn_s):
        self.theta.copy_(theta)
        self.theta_hat.copy_(theta_hat)
        _copy_tree_(self.up_s, up_s)
        _copy_tree_(self.dn_s, dn_s)

    def _round(self):
        """Static plan: train, uplink, aggregate, downlink."""
        plan = self.plans[0]
        kt, ctx = self._key_and_ctx(plan)
        payload, priors = self.engine._train(kt, self.theta_hat, self.x, self.y,
                                             None if self.full else self.active)
        theta, theta_hat, up_s, dn_s, update, ul, dl, oh = self.engine._round_core(
            plan, self.theta, self.theta_hat, self.up_s, self.dn_s, payload, priors, ctx)
        self._store(theta, theta_hat, up_s, dn_s)
        self.booked.setdefault("round", (ul, dl, oh, update.lr))

    def _sync(self):
        """The periodic EF flush, at the step size the round recorded."""
        theta, theta_hat, up_s, dn_s, b_up, b_dn = self.engine._flush(
            self.theta, self.up_s, self.dn_s, self.booked["round"][3], self.n, self.d)
        self._store(theta, theta_hat, up_s, dn_s)
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
        _, ctx = self._key_and_ctx(plan)
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

    def _play(self, name, fn) -> None:
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

    def run(self, shards, theta, theta_hat, meter, *, seed, schedule, eval_mask,
            flush_mask) -> Dict[str, Any]:
        spec, n, d = self.engine.spec, self.n, self.d
        dev = self.theta.device
        self.x.copy_(shards.x)
        self.y.copy_(shards.y)
        self.theta.copy_(theta)
        self.theta_hat.copy_(theta_hat)
        _copy_tree_(self.up_s, spec.uplink.init_up_state(n, d, dev))
        _copy_tree_(self.dn_s, spec.downlink.init_down_state(n, d, dev))
        self.base.copy_(prng.PRNGKey(seed, device=dev))
        self.sched.copy_(torch.as_tensor(schedule, dtype=torch.int64))
        buckets = []
        for t in range(self.rounds):
            self.t.fill_(t)
            self.active.copy_(self.sched[t])
            if self.adaptive:
                self._play("stats", self._stats)
                b = int(self.bidx)    # the round's one device-to-host read
                buckets.append(b)
                self._play(("bucket", b), lambda b=b: self._bucket(b))
            else:
                self._play("round", self._round)
                if flush_mask[t]:
                    self._play("flush", self._sync)
            if eval_mask[t]:
                self._play("eval", self._eval)
        accs = self.accs.cpu().numpy()
        if self.adaptive:
            ul, dl, oh = self.bits.cpu().numpy().astype(np.float64)
            # Exact while every per-round total stays below 2**24 (integers
            # times log2 of a pow2 n_is in float32), as the reference guards.
            if max((float(np.max(np.abs(v))) if v.size else 0.0) for v in (ul, dl, oh)) \
                    >= 2.0 ** 24:
                raise OverflowError(
                    "per-round bits exceed the float32 integer-exact range (2**24); "
                    "run mode='host' for exact accounting at this scale")
            snaps = meter.book_run(ul, dl, overhead_bits=oh, snapshot_mask=eval_mask)
        elif self.rounds:
            ul, dl, oh, _ = self.booked["round"]
            fl_up, fl_dn = self.booked.get("flush", (0.0, 0.0))
            snaps = meter.book_run(
                [ul + (fl_up if flush_mask[t] else 0.0) for t in range(self.rounds)],
                [dl + (fl_dn if flush_mask[t] else 0.0) for t in range(self.rounds)],
                overhead_bits=oh, snapshot_mask=eval_mask)
        else:
            snaps = []
        history = [{"round": int(t) + 1, "acc": float(accs[t]), "cum_bits": cum_bits,
                    "bpp_so_far": bpp}
                   for t, (cum_bits, bpp) in zip(np.nonzero(eval_mask)[0], snaps)]
        out = self.engine._result(history, meter, self.theta.clone(),
                                  self.theta_hat.clone())
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
