"""The program's own spans (``repro_torch.spans``) of the first traced pass.

A ``--trace 1`` run records the program's spans in every pass that runs
under the profiler: the device-only pass, a repeat where that pass lost
records, and the host-and-device pass that labels the idle gaps and slows
the host.  The readers take the first pass only: in start order, the
first ``count`` spans named ``unit`` (``fl.round`` for FL, ``train.step``
for training) and every span inside them.  Where the program records no
such spans (a program without ``repro_torch.spans``, or fewer units than
the context names), every reader gets None.
"""
from __future__ import annotations

from typing import Callable, List, Optional


def first_pass(unit: str, count: int) -> Optional[list]:
    """The records of the first ``count`` ``unit`` spans and their
    descendants, or None."""
    try:
        from repro_torch import spans
    except ImportError:
        return None
    recs = spans.records()
    units = [r for r in recs if r.name == unit][:count]
    if count <= 0 or len(units) < count:
        return None
    keep = {r.index for r in units}
    for r in recs:                      # parents come before their children
        if r.parent in keep:
            keep.add(r.index)
    return [r for r in recs if r.index in keep]


def device_ms(recs: Optional[List], pick: Callable[[str], bool], count: int) -> Optional[float]:
    """Device ms of the spans whose name ``pick`` accepts, per unit; None
    where there are none, or one lacks a device time."""
    got = [r for r in recs or () if pick(r.name)]
    if not got or any(r.device_ms is None for r in got):
        return None
    return sum(r.device_ms for r in got) / count


def host_ms(recs: Optional[List], pick: Callable[[str], bool], count: int) -> Optional[float]:
    """Host ms of the spans whose name ``pick`` accepts, per unit; None
    where there are none."""
    got = [r for r in recs or () if pick(r.name)]
    return sum(r.host_ms for r in got) / count if got else None
