"""What every driver hands back, and the one result line built from it."""
from __future__ import annotations

import importlib.util
import math
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

import torch

METRICS = Path(__file__).resolve().parent / "metrics"


@dataclass
class Result:
    """One run: the work attempted and failed, the end-to-end numbers, the
    traced window (with ``--trace 1``) and what its readers need, the
    numbers compared with the reference, each with its limit, and the peak
    device memory, read before the reference ran."""

    attempted: int
    failed: int
    e2e: Dict[str, float]
    checks: List[Tuple[str, float, float]]
    memory_peak_bytes: int
    trace: Optional[object] = None
    ctx: Dict = field(default_factory=dict)


def closed_loop(seconds: float, one: Callable[[], None], clock) -> Tuple[int, float]:
    """Call ``one`` back to back until ``seconds`` have passed: (calls,
    elapsed seconds)."""
    calls, t0 = 0, clock()
    while True:
        one()
        calls += 1
        elapsed = clock() - t0
        if elapsed >= seconds:
            return calls, elapsed


def _reader(name: str):
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}",
                                                  METRICS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def correct(res: Result) -> bool:
    return res.failed == 0 and bool(res.checks) and all(
        math.isfinite(v) and v <= lim for _, v, lim in res.checks)


def result_line(res: Result, e2e: List[dict], per_layer: List[dict], *, trace: bool,
                log) -> dict:
    metrics = {}
    if trace:
        for m in per_layer:
            v = _reader(m["name"])(res.trace, res.ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in e2e:
            metrics[m["name"]] = {"value": res.e2e[m["name"]], "unit": m["unit"]}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1,
              "memory_peak_bytes": int(res.memory_peak_bytes)}
    line = {"correct": correct(res), "attempted": res.attempted, "failed": res.failed,
            "metrics": metrics, "device": device}
    if trace:
        from portbench.yardstick.trace import breakdown
        device["busy_s"] = res.trace.busy_s()
        device["window_s"] = res.trace.window_s
        line["breakdown"] = breakdown(res.trace)
    for name, v, lim in res.checks:
        log(f"check {name}: {v!r} (limit {lim!r})")
    line["checks"] = {name: {"value": v, "limit": lim} for name, v, lim in res.checks}
    return line
