"""The op cost model: FLOPs, bytes and peak live memory of a traced call
(the counterpart of ``repro.launch.hlo_cost``, which reads compiled HLO).

The port has no HLO: ``OpCost`` is a ``TorchDispatchMode`` that sees every
aten op a call dispatches, on any device.  On the ``meta`` device nothing
runs and nothing is allocated, so a full-size model is traced on the host
(``launch/dryrun.py``).

* **FLOPs**: ``torch.utils.flop_counter``'s formulas, 2 M N K for every
  matrix product (``mm``, ``bmm``, ``addmm``, the convolutions, SDPA), as
  ``hlo_cost`` counts ``dot``s; elementwise work is not counted.  A hand-
  written kernel is called through ``ctypes``, below the dispatcher, so its
  wrapper reports its work (``kernels.cost``) instead.
* **HBM bytes**: operand plus output bytes of every aten op that is not a
  view.  Eager torch fuses nothing, so this is the eager program's own
  traffic; ``hlo_cost`` counts the same per top-level instruction of XLA's
  post-fusion program, whose fusions keep their internal traffic on chip.
* **Peak live bytes**: the high-water mark of the bytes of the storages the
  call allocated and still holds (frees are seen through weak references
  to the storages, which autograd's saved tensors keep alive).  Storages
  that existed before (the arguments) are not counted.
* **Loops**: ``hlo_cost`` multiplies a ``while`` body by its trip count;
  here ``repeat(n)`` scales what is counted inside it by ``n``
  (``kernels.cost``), and the port's long per-step loops (the microbatches
  of a train step, the Mamba token scan, the RWKV chunk loop) trace one
  step under it on ``meta``.  Peak live bytes are not scaled.
* **Collectives**: the port runs on one card and dispatches none, so the
  trace leaves ``coll_bytes``/``coll_count`` empty; the dry run fills them
  with ``launch.roofline.collective_schedule``'s model of the schedule.
"""
from __future__ import annotations

import weakref
from dataclasses import dataclass, field
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels import cost as _cost
from repro_torch.kernels.cost import repeat, repeated  # noqa: F401  (the loop hooks)

aten = torch.ops.aten
# Ops that allocate without writing: no traffic.
_NO_TRAFFIC = {aten.empty.memory_format, aten.empty_strided.default, aten.empty_like.default,
               aten.new_empty.default, aten.new_empty_strided.default}


@dataclass
class CostTotals:
    flops: float = 0.0
    hbm_bytes: float = 0.0
    coll_bytes: Dict[str, float] = field(default_factory=dict)
    coll_count: Dict[str, float] = field(default_factory=dict)
    ops: Dict[str, float] = field(default_factory=dict)   # dispatches; kernels "kernel:<name>"
    peak_live_bytes: float = 0.0
    flops_by_region: Dict[str, float] = field(default_factory=dict)  # "" outside any region


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class OpCost(TorchDispatchMode):
    """``with OpCost() as oc: fn(...)``, then ``oc.totals``."""

    def __init__(self):
        super().__init__()
        self.totals = CostTotals()
        self._live = 0
        self._seen: Dict[int, int] = {}    # storage -> bytes it counts (0: it existed before)

    def __enter__(self):
        _cost._SINKS.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _cost._SINKS.remove(self)
        return super().__exit__(*exc)

    def _count(self, name: str, flops: float, nbytes: float) -> None:
        sc = _cost.scale()
        t = self.totals
        t.flops += flops * sc
        t.hbm_bytes += nbytes * sc
        t.ops[name] = t.ops.get(name, 0.0) + sc
        if flops:
            region = _cost.current_region()
            t.flops_by_region[region] = t.flops_by_region.get(region, 0.0) + flops * sc

    def add_kernel(self, name: str, work: _cost.Work) -> None:
        """A kernel launch's work (``kernels.cost.report``)."""
        self._count(f"kernel:{name}", work.flops, work.nbytes)

    def _free(self, key: int, nbytes: int) -> None:
        self._live -= nbytes
        self._seen.pop(key, None)

    def _storages(self, tensors, new: bool) -> None:
        for t in tensors:
            st = t.untyped_storage()
            key = st._cdata
            if key in self._seen:
                continue
            nbytes = st.nbytes() if new else 0
            self._seen[key] = nbytes
            if nbytes:
                self._live += nbytes
                self.totals.peak_live_bytes = max(self.totals.peak_live_bytes, self._live)
            weakref.finalize(st, self._free, key, nbytes)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        ins = [t for t in tree_leaves((args, kwargs)) if isinstance(t, torch.Tensor)]
        self._storages(ins, new=False)
        out = func(*args, **kwargs)
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        packet = func.overloadpacket
        flops = flop_registry[packet](*args, **kwargs, out_val=out) \
            if packet in flop_registry else 0
        nbytes = 0 if func.is_view or func in _NO_TRAFFIC \
            else sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
        self._count(packet.__name__, flops, nbytes)
        self._storages(outs, new=True)
        return out


def analyze(fn, *args, **kwargs) -> CostTotals:
    """``fn(*args, **kwargs)`` traced under ``OpCost``; its totals."""
    with OpCost() as oc:
        fn(*args, **kwargs)
    return oc.totals
