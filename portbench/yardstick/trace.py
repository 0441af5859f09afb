"""The traced window: device operations and busy time from a light
``torch.profiler`` trace of the card alone, and the idle gaps labelled by
the host op in each from a second, full trace of the same work.

The first pass records device activity only (no host ops), so the work
runs close to its untraced pace: the window is the host clock's span from
a device synchronise before the work to one after it, and busy time is the
union of the device operations' intervals, all of which fall inside it.  A
trace that holds fewer records than the caller expects lost some of them:
it is taken again, and after ``passes`` incomplete traces the run fails
rather than report a short count as a time.  The second pass runs the same
work once more under host and device tracing, inside the window
annotation, and only labels its gaps.  Traces stay in memory; nothing is
written.
"""
from __future__ import annotations

import heapq
import time
from collections import defaultdict
from typing import Callable, Dict, List, Tuple

import torch

WINDOW = "portbench.window"


class IncompleteTrace(RuntimeError):
    """Every pass of the profiler lost device records."""


class Trace:
    """Device operations ``(name, start_ns, end_ns)`` of one traced window,
    its length on the host clock, and its idle time by host op
    (``[name, seconds]``, most first) from the labelling pass."""

    def __init__(self, device_ops, window_s: float, gaps=()):
        self.device_ops = device_ops
        self.window_s = window_s
        self.gaps = [list(g) for g in gaps]

    def merged(self) -> List[Tuple[int, int]]:
        return merged(self.device_ops)

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.merged()) / 1e9

    def device_seconds(self, pick: Callable[[str], bool]) -> float:
        """Device time of the operations whose name ``pick`` accepts."""
        return sum(e - s for n, s, e in self.device_ops if pick(n)) / 1e9

    def count(self, pick: Callable[[str], bool]) -> int:
        return sum(1 for n, _, _ in self.device_ops if pick(n))

    def top_ops(self, k: int = 10) -> List[list]:
        by = defaultdict(int)
        for n, s, e in self.device_ops:
            by[n] += e - s
        return [[n[:120], v / 1e9] for n, v in sorted(by.items(), key=lambda kv: -kv[1])[:k]]

    def idle_gaps(self, k: int = 10) -> List[list]:
        return self.gaps[:k]


def merged(device_ops, t0=None, t1=None) -> List[Tuple[int, int]]:
    """The union of the device intervals, cut to ``[t0, t1]`` where given."""
    lo = -float("inf") if t0 is None else t0
    hi = float("inf") if t1 is None else t1
    spans = sorted((max(s, lo), min(e, hi)) for _, s, e in device_ops if e > lo and s < hi)
    out: List[List[int]] = []
    for s, e in spans:
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def label_gaps(device_ops, host_ops, t0: int, t1: int) -> List[list]:
    """Idle time of the window ``[t0, t1]`` summed by the innermost host
    event running at each gap's middle (``idle host`` where none ran)."""
    edges, prev = [], t0
    for s, e in merged(device_ops, t0, t1):
        if s > prev:
            edges.append((prev, s))
        prev = max(prev, e)
    if t1 > prev:
        edges.append((prev, t1))
    host = sorted(host_ops, key=lambda h: h[1])
    by = defaultdict(int)
    # A sweep over the gaps' middles in order: ``live`` is a max-heap by
    # start of the host events begun so far; one that ended before this
    # middle ended before every later one, so it is dropped for good.
    live, i = [], 0
    for s, e in edges:
        mid = (s + e) // 2
        while i < len(host) and host[i][1] <= mid:
            heapq.heappush(live, (-host[i][1], host[i][2], host[i][0]))
            i += 1
        while live and live[0][1] < mid:
            heapq.heappop(live)
        by[live[0][2] if live else "idle host"] += e - s
    return [[n[:120], v / 1e9] for n, v in sorted(by.items(), key=lambda kv: -kv[1])]


def _events(prof):
    """(device operations, host events, the window annotation's span or
    None); a device operation is a kernel, copy or fill on the device's
    timeline, not an annotation drawn there."""
    dev, host, window = [], [], None
    for e in prof.profiler.kineto_results.events():
        s, d = e.start_ns(), e.duration_ns()
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if not e.is_user_annotation() and e.name() != WINDOW:
                dev.append((e.name(), s, s + d))
        elif e.name() == WINDOW:
            window = (s, s + d)
        else:
            host.append((e.name(), s, s + d))
    return dev, host, window


def trace_window(fn: Callable[[], None], complete: Callable[[Trace], bool],
                 passes: int = 3, log=print) -> Trace:
    """Run ``fn`` under device tracing until ``complete(trace)`` holds (raise
    ``IncompleteTrace`` after ``passes``), then once more under host and
    device tracing to label the idle gaps."""
    P = torch.profiler.ProfilerActivity
    for i in range(passes):
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[P.CUDA]) as prof:
            a = time.perf_counter_ns()
            fn()
            torch.cuda.synchronize()
            b = time.perf_counter_ns()
        dev, _, _ = _events(prof)
        tr = Trace(dev, (b - a) / 1e9)
        if dev and complete(tr):
            break
        log(f"trace pass {i + 1}: device records incomplete "
            f"({len(dev)} device operations); tracing again")
    else:
        raise IncompleteTrace(f"the profiler lost device records in all {passes} passes")
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[P.CPU, P.CUDA]) as prof:
        with torch.profiler.record_function(WINDOW):
            fn()
            torch.cuda.synchronize()
    dev, host, window = _events(prof)
    if window is not None:
        tr.gaps = label_gaps(dev, host, *window)
    return tr


def breakdown(tr: Trace) -> Dict[str, list]:
    return {"device_ops": tr.top_ops(), "idle_gaps": tr.idle_gaps()}
