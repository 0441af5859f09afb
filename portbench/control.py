"""The control and the planted faults of a cell, at the cell's own size.

    python3 portbench/control.py --workload <cell> --seeds <n> [<n> ...] [--program]

Each reading puts the plain reference, changed, in the program's place and
compares it with the plain reference as a benchmark run compares the
program: the reference computed one precision below the configuration's
(the control), and for a training cell the reference with half of each
microbatch left out (a planted fault).  A step that returns its state
unchanged reads 1 on the gradient and change numbers by their definition
and needs no run.  With ``--program`` it reads the program instead: a run
of the cell's driver on each seed (set-up, a window of one call, the
check), all in one process, which is how a dozen seeds' sound readings are
taken where set-up is long.  One JSON line per seed; the benchmark's own
runs never run this.  Needs the card.
"""
from __future__ import annotations

import argparse
import importlib
import json
import random
import sys
from pathlib import Path

sys.path[:0] = [str(Path(__file__).resolve().parents[1])]

import torch  # noqa: E402

from portbench.run import _paths, cell  # noqa: E402


def fl_readings(cfg, traffic, seed, device):
    from portbench.reference import fl_mask
    from portbench.yardstick import fl_data
    inputs = fl_data.make_inputs(seed, cfg, device)
    worst = {}
    for job_seed in random.Random(seed).sample(range(seed + 1, seed + 200),
                                               traffic["judged_jobs"]):
        ref = fl_mask.run_job(inputs, job_seed, cfg, traffic)
        ctl = fl_mask.run_job(inputs, job_seed, cfg, traffic, tf32=True)
        gaps = fl_mask.compare(ctl, ref)
        worst = {n: max(v, worst.get(n, 0.0)) for n, v in gaps.items()}
    return {"control": worst}


def train_readings(cfg, traffic, seed, device):
    from portbench.drivers.train_steps import CHECKED_STEPS
    from portbench.reference import qwen3_train
    from portbench.yardstick import lm_params
    from portbench.yardstick.lm_stream import TokenStream
    stream = TokenStream(cfg["vocab_size"], seed).stream(traffic["batch"], traffic["seq"])
    batches = [next(stream) for _ in range(CHECKED_STEPS)]

    def steps(**kw):
        out = qwen3_train.run_steps(cfg, lm_params.draw(cfg, seed, device), batches, traffic,
                                    seed, **kw)
        torch.cuda.empty_cache()
        return out

    ref = steps()
    return {"control": qwen3_train.compare(steps(low=True), ref),
            "half_batch": qwen3_train.compare(steps(half_batch=True), ref),
            "reference_losses": ref["losses"]}


def program_readings(driver, seconds):
    def read(cfg, traffic, seed, device):
        res = driver.run(cfg, traffic, seed=seed, seconds=seconds, trace=False, device=device,
                         t_start=0.0, log=lambda m: print(m, file=sys.stderr))
        torch.cuda.empty_cache()
        return {"program": {n: v for n, v, _ in res.checks}}
    return read


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--program", action="store_true")
    ap.add_argument("--seconds", type=float, default=0.001,
                    help="the window of each --program run")
    args = ap.parse_args(argv)
    _paths()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    c = cell(args.workload)
    kind = c["traffic"]["driver"]
    if args.program:
        read = program_readings(importlib.import_module(f"portbench.drivers.{kind}"),
                                args.seconds)
    else:
        read = {"fl_jobs": fl_readings, "train_steps": train_readings}[kind]
    for seed in args.seeds:
        out = read(c["config"], c["traffic"], seed, "cuda")
        print(json.dumps({"workload": args.workload, "seed": seed, **out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
