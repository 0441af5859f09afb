"""FL jobs back to back on one engine: a researcher's sweep over seeds.

Set-up makes the shards, the test set and the frozen weights from the seed
on the device, builds the task and the scheme (``fl.registry
.bicompfl_spec``) and runs one job, which builds the kernels and captures
the round as CUDA graphs (the engine's default mode).  The window then runs
jobs of the traffic's rounds, job seeds counting up from the seed, each
timed from the call to ``FLEngine.run`` until its model is on the host.
Afterwards a sample of the window's jobs, drawn from the seed, is run again
by the plain reference and compared: the final model entry by entry, the
booked bits and the accuracy at every eval round, each exactly.
"""
from __future__ import annotations

import itertools
import random
import time

import torch

from portbench.harness import Result, closed_loop
from portbench.reference import fl_mask
from portbench.yardstick import fl_data, peaks
from portbench.yardstick.trace import trace_window


def build(cfg, traffic, seed, device):
    """The engine, the shards and the inputs (the program's objects over the
    benchmark's inputs)."""
    from repro_torch.core.blocks import FixedAllocation
    from repro_torch.fl.data import Dataset
    from repro_torch.fl.engine import FLEngine
    from repro_torch.fl.nets import MLP, flatten_weights
    from repro_torch.fl.registry import bicompfl_spec
    from repro_torch.fl.tasks import MaskTask

    inputs = fl_data.make_inputs(seed, cfg, device)
    dims = inputs["dims"]
    net = MLP(dims, signed_constant=True, device=device)
    _, unravel = flatten_weights([torch.empty(a, b) for a, b in zip(dims[:-1], dims[1:])])
    task = MaskTask(net=net, w0_flat=inputs["w0"], unravel=unravel, x_test=inputs["x_test"],
                    y_test=inputs["y_test"], local_epochs=cfg["local_epochs"],
                    batch_size=cfg["batch_size"], lr=cfg["lr"])
    if traffic["allocation"] != "fixed":
        raise ValueError(f"allocation {traffic['allocation']!r}: this driver runs fixed blocks")
    spec = bicompfl_spec(traffic["variant"], allocation=FixedAllocation(traffic["block_size"]),
                         n_is=traffic["n_is"], n_ul=1, n_dl=cfg["n_clients"])
    return FLEngine(task, spec), Dataset(x=inputs["x"], y=inputs["y"]), inputs


def _own_launches():
    from repro_torch.kernels import ops
    return sum(f.launches for f in (ops.mrc_logw, ops.mrc_fixed_encode, ops.bernoulli_kl,
                                    ops.bernoulli_kl_total, ops.bernoulli_kl_profile,
                                    ops.segment_logw, ops.segment_mrc_encode,
                                    ops.segment_select))


def run(cfg, traffic, *, seed, seconds, trace, device, t_start, log) -> Result:
    rounds, every = traffic["rounds"], traffic["eval_every"]
    log(f"set-up: driver started at {time.perf_counter() - t_start:.3f} s")
    engine, shards, inputs = build(cfg, traffic, seed, device)
    log(f"set-up: inputs made at {time.perf_counter() - t_start:.3f} s")
    on_card = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    done = []                       # (job seed, theta on the host, bits, accs)

    def job(job_seed):
        out = engine.run(shards, rounds=rounds, seed=job_seed, eval_every=every)
        done.append((job_seed, out["theta"].cpu(), out["meter"]["total_bits"],
                     {h["round"]: h["acc"] for h in out["history"]}))

    before = _own_launches()
    job(seed)                       # builds the kernels, captures the graphs
    # Each graph holding a kernel counts it twice at capture (its eager
    # warm-up and the capture), never at replay.
    own_per_round = (_own_launches() - before) // 2
    done.clear()
    sync()
    setup_s = time.perf_counter() - t_start
    counter = itertools.count(seed + 1)
    res_trace, ctx = None, {}
    if trace:
        n_jobs = traffic["traced_jobs"]

        def traced():
            for _ in range(n_jobs):
                job(next(counter))

        def complete(tr):
            return tr.count(peaks.is_own_fl_kernel) >= own_per_round * rounds * n_jobs

        res_trace = trace_window(traced, complete, log=log)
        done[:] = done[-n_jobs:]
        units = rounds * n_jobs
        ctx = {"rounds": units, "fl_flops": units * round_flops(cfg, every, rounds)}
        e2e = {}
        attempted = n_jobs
    else:
        calls, elapsed = closed_loop(seconds, lambda: job(next(counter)),
                                            time.perf_counter)
        attempted = calls
        e2e = {"fl_rounds_per_s": calls * rounds / elapsed, "setup_s": setup_s}
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    checks = judge(inputs, cfg, traffic, seed, done)
    return Result(attempted=attempted, failed=0, e2e=e2e, checks=checks,
                  memory_peak_bytes=peak, trace=res_trace, ctx=ctx)


def round_flops(cfg, every, rounds) -> float:
    """Model FLOPs of one round, averaged over a job: each client's local
    steps through the masked MLP forward and backward (3 x 2 x weights x
    batch), and the eval forwards over the test set."""
    dims = [cfg["hw"] * cfg["hw"], *cfg["widths"], cfg["n_classes"]]
    d = sum(a * b for a, b in zip(dims[:-1], dims[1:]))
    shard = cfg["n_train"] // cfg["n_clients"]
    bs = min(cfg["batch_size"], shard)
    steps = cfg["local_epochs"] * max(shard // bs, 1)
    train = cfg["n_clients"] * steps * 6 * d * bs
    evals = len({*range(every, rounds + 1, every), rounds})
    return train + evals * 2 * d * cfg["n_test"] / rounds


def judge(inputs, cfg, traffic, seed, done):
    """The sampled jobs against the plain reference, each number the worst
    over the sampled jobs."""
    k = min(traffic["judged_jobs"], len(done))
    worst = {}
    for i in random.Random(seed).sample(range(len(done)), k):
        job_seed, theta, bits, accs = done[i]
        gaps = fl_mask.compare({"theta": theta, "total_bits": bits, "accs": accs},
                               fl_mask.run_job(inputs, job_seed, cfg, traffic))
        worst = {n: max(v, worst.get(n, 0.0)) for n, v in gaps.items()}
    lim = traffic["limits"]
    return [(n, worst.get(n, float("inf")), lim[n]) for n in lim]
