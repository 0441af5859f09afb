"""Named spans of the port's work, on the profiler's clock and the card's.

The port marks where its layers start and end::

    with spans.span("fl.train", device):
        ...

A span is off unless a ``torch.profiler`` session records (any session
sets ``torch.autograd.profiler._is_profiler_enabled``) or the code runs
inside ``spans.recording()``.  Off, ``span`` costs one flag check and
returns a shared no-op context: nothing is recorded and nothing is
launched.  On, a span

* enters ``torch.profiler.record_function(name)``, so the range is part of
  the profiler's own trace (its exported Chrome trace shows it by name,
  beside the operators and kernels it holds, on the device trace's clock);
* appends a record to an in-memory buffer of at most ``LIMIT`` records
  (later ones are dropped and counted, ``dropped()``): its name, the
  enclosing span, and its host start and end (``time.perf_counter_ns``);
* where ``device`` is a CUDA device, records a CUDA timing event on the
  current stream at its start and at its end, so its device time is the
  time the stream took from one to the other.  No event is recorded while
  the stream is capturing a CUDA graph, and no span synchronises.

Spans never change what runs: on or off, the same operations are issued
in the same order.  Meta and CPU work get host times only.

Seeing the spans:

* in any ``torch.profiler`` session, by name among the events
  (``prof.key_averages()``, ``prof.export_chrome_trace(path)``);
* without a profiler::

      from repro_torch import spans
      spans.clear()
      with spans.recording():
          engine.run(shards, rounds=15)
      for name, s in spans.summary().items():
          print(name, s["calls"], s["device_ms"], s["self_ms"])

``records()`` resolves the device times with one synchronise and must not
be called inside a span; ``summary()`` gives per name the calls and the
summed host, device and self time.  The names the port records:

* ``fl.job`` (``FLEngine.run``), ``fl.round`` (each round of either path),
  inside it ``fl.train`` (local training: the fused static train graph,
  the adaptive stats graph, the host loop's ``_train``), ``fl.codec``
  (uplink, aggregate, downlink: the fused static codec graph, an adaptive
  bucket graph, the host loop's plan and codec), ``fl.eval``, ``fl.flush``
  (the fused EF flush graph) and ``fl.book`` (the fused path's booking);
* ``train.step`` (``Trainer.step``), inside it ``train.fwd_bwd`` (one a
  microbatch: loss, gradients, their accumulation), ``train.sign`` (the
  stochastic sign over every leaf), ``train.update`` (the optimizer) and
  ``train.sync`` (the loss read back to the host);
* ``kernel.<wrapper>`` around every launch of a hand-written kernel
  through ``kernels.ops`` (its checks, the ctypes call and the launcher).
"""
from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, List, NamedTuple, Optional

import torch
import torch.autograd.profiler as _profiler

LIMIT = 1 << 18


class Record(NamedTuple):
    """One closed span.  ``index`` is its place in the buffer (start order),
    ``parent`` the index of the span open around it (-1 at the top; a
    span opened on another thread, such as autograd's, nests under the
    innermost span open anywhere), ``device_ms`` None off the card or
    where the span began or ended inside a graph capture."""

    index: int
    name: str
    parent: int
    start_ns: int
    end_ns: int
    device_ms: Optional[float]

    @property
    def host_ms(self) -> float:
        return (self.end_ns - self.start_ns) / 1e6


_lock = threading.Lock()
_buf: List[list] = []       # [name, parent, start_ns, end_ns, events or device ms]
_open: List[int] = []       # indices of the spans open now, innermost last
_dropped = 0
_forced = 0
_OFF = contextlib.nullcontext()


def _event_pair_start(device):
    if device is None or torch.device(device).type != "cuda" \
            or torch.cuda.is_current_stream_capturing():
        return None
    start = torch.cuda.Event(enable_timing=True)
    start.record(torch.cuda.current_stream(device))
    return start


class _Span:
    __slots__ = ("name", "device", "rf", "index", "start")

    def __init__(self, name: str, device):
        self.name, self.device = name, device

    def __enter__(self):
        global _dropped
        self.rf = torch.profiler.record_function(self.name)
        self.rf.__enter__()
        with _lock:
            if len(_buf) >= LIMIT:
                self.index = None
                _dropped += 1
            else:
                self.index = len(_buf)
                _buf.append([self.name, _open[-1] if _open else -1, 0, 0, None])
                _open.append(self.index)
        self.start = _event_pair_start(self.device) if self.index is not None else None
        if self.index is not None:
            _buf[self.index][2] = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        if self.index is not None:
            end_ns = time.perf_counter_ns()
            end = None
            if self.start is not None and not torch.cuda.is_current_stream_capturing():
                end = torch.cuda.Event(enable_timing=True)
                end.record(torch.cuda.current_stream(self.device))
            with _lock:
                rec = _buf[self.index]
                rec[3] = end_ns
                rec[4] = (self.start, end) if end is not None else None
                _open.remove(self.index)
        self.rf.__exit__(*exc)
        return False


def span(name: str, device=None):
    """A context that marks ``name`` around the work inside it; ``device``
    is where that work runs (a CUDA device adds device times)."""
    if not (_forced or _profiler._is_profiler_enabled):
        return _OFF
    return _Span(name, device)


@contextlib.contextmanager
def recording():
    """Record spans inside this context, with or without a profiler."""
    global _forced
    with _lock:
        _forced += 1
    try:
        yield
    finally:
        with _lock:
            _forced -= 1


def _check_closed(what: str) -> None:
    if _open:
        raise RuntimeError(f"spans.{what}() inside an open span "
                           f"({[_buf[i][0] for i in _open]})")


def records() -> List[Record]:
    """Every closed span since the last ``clear()``, in start order, with
    its device time resolved (one ``torch.cuda.synchronize`` where any is
    pending)."""
    with _lock:
        _check_closed("records")
        pending = [r for r in _buf if isinstance(r[4], tuple)]
        if pending:
            torch.cuda.synchronize()
            for r in pending:
                r[4] = r[4][0].elapsed_time(r[4][1])
        return [Record(i, *r) for i, r in enumerate(_buf)]


def clear() -> None:
    """Empty the buffer and the count of dropped records."""
    global _dropped
    with _lock:
        _check_closed("clear")
        _buf.clear()
        _dropped = 0


def dropped() -> int:
    """Spans not recorded since the last ``clear()``: the buffer was full."""
    return _dropped


def summary(recs: Optional[List[Record]] = None) -> Dict[str, dict]:
    """Per name, over ``recs`` (default ``records()``): ``calls``,
    ``host_ms`` and ``device_ms`` summed (``device_ms`` None where a call
    has none), and ``self_ms``, the span's time minus the time of its
    children among ``recs``: on the device's clock where the span has a
    device time (children on one stream follow one another inside it), else
    on the host's, as the part of the span that no child covers."""
    recs = records() if recs is None else recs
    kids: Dict[int, List[Record]] = {}
    for r in recs:
        kids.setdefault(r.parent, []).append(r)
    out: Dict[str, dict] = {}
    for r in recs:
        s = out.setdefault(r.name, {"calls": 0, "host_ms": 0.0, "device_ms": 0.0,
                                    "self_ms": 0.0})
        s["calls"] += 1
        s["host_ms"] += r.host_ms
        ch = kids.get(r.index, [])
        if r.device_ms is not None:
            s["self_ms"] += max(0.0, r.device_ms - sum(c.device_ms or 0.0 for c in ch))
        else:
            s["self_ms"] += r.host_ms - _covered_ms(r, ch)
        if s["device_ms"] is not None:
            s["device_ms"] = None if r.device_ms is None else s["device_ms"] + r.device_ms
    return out


def _covered_ms(r: Record, children: List[Record]) -> float:
    """Host ms of ``r``'s interval that the union of ``children`` covers."""
    covered, reach = 0, r.start_ns
    for c in sorted(children, key=lambda c: c.start_ns):
        lo, hi = max(c.start_ns, reach), min(c.end_ns, r.end_ns)
        if hi > lo:
            covered += hi - lo
            reach = hi
    return covered / 1e6
