"""Roofline terms from a traced (dry-run) step (port of ``repro.launch.roofline``).

Three terms, each in seconds per device (H100 constants from ``mesh.py``):

    compute    = FLOPs per device / peak (989 TFLOP/s bf16, 67 f32)
    memory     = HBM bytes per device / 3.35 TB/s
    collective = collective bytes per device / LINK_BW (50 GB/s)

The reference reads a compiled SPMD executable: ``compiled.memory_analysis``
and per-device HLO.  ``analyze(totals, mesh, arguments)`` reads the port's
``op_cost`` trace of the whole (global) step instead.  The reference's
``_shape_bytes`` and ``parse_collectives`` read HLO text and have no
counterpart here.

* **FLOPs and HBM bytes per device** are the traced totals divided by the
  chips, on the assumption that the specs split every product and every
  byte evenly over the mesh.
* **Argument bytes** are exact: each argument leaf's ``shard_bytes`` under
  its sanitized spec, summed (outputs alike).
* **Temp bytes** are the trace's peak live bytes (what it allocated beyond
  its arguments) divided by the chips.
* **Collective bytes** are the port's model of the schedule, by one rule
  over the spec trees (``collective_schedule``), in the reference's
  output-size convention per device: no compiler chose them.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, Iterable, Optional, Tuple

from repro_torch.models import sharding
from repro_torch.models.sharding import P, is_spec
from repro_torch.tree import tree_leaves
from .mesh import HBM_BW, LINK_BW, PEAK_FLOPS_BF16, Mesh

@dataclass
class CollectiveStats:
    bytes_by_kind: Dict[str, int] = field(default_factory=dict)
    count_by_kind: Dict[str, int] = field(default_factory=dict)

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes_by_kind.values())

    @property
    def total_count(self) -> int:
        return sum(self.count_by_kind.values())

    def add(self, kind: str, nbytes: int, count: int = 1) -> None:
        if count and nbytes:
            self.bytes_by_kind[kind] = self.bytes_by_kind.get(kind, 0) + nbytes * count
            self.count_by_kind[kind] = self.count_by_kind.get(kind, 0) + count


@dataclass
class Roofline:
    flops: float                   # per device
    hbm_bytes: float               # per device
    collective_bytes: float        # per device
    chips: int
    peak_flops: float = PEAK_FLOPS_BF16
    compute_s: float = 0.0
    memory_s: float = 0.0
    collective_s: float = 0.0

    def __post_init__(self):
        self.compute_s = self.flops / self.peak_flops
        self.memory_s = self.hbm_bytes / HBM_BW
        self.collective_s = self.collective_bytes / LINK_BW

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        """Optimistic (perfect-overlap) step-time bound: max of the terms."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    def row(self) -> Dict[str, float]:
        return {
            "flops_per_dev": self.flops, "hbm_bytes_per_dev": self.hbm_bytes,
            "coll_bytes_per_dev": self.collective_bytes,
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "collective_s": self.collective_s, "dominant": self.dominant,
            "bound_s": self.step_time_s,
        }


def _pairs(trees: Iterable[Tuple]) -> Iterable[Tuple]:
    """(leaf, spec) over (tree, spec tree) pairs; a leaf that is not a
    tensor (Adam's step count, a Python int) holds no device bytes."""
    for tree, specs in trees:
        for leaf, spec in zip(tree_leaves(tree), tree_leaves(specs, is_leaf=is_spec)):
            if hasattr(leaf, "shape"):
                yield leaf, spec


def sharded_bytes(mesh: Mesh, trees: Iterable[Tuple]) -> int:
    """Bytes one device holds of (tree, spec tree) pairs."""
    return sum(sharding.Sharding(mesh, spec).shard_bytes(tuple(leaf.shape), leaf.dtype)
               for leaf, spec in _pairs(trees))


def _drop(spec: P, axis: str) -> P:
    return P(*(None if e == axis else e for e in spec))


def collective_schedule(mesh: Mesh, kind: str, params, param_specs, *,
                        activation_bytes: int, mixer_outputs: int,
                        microbatches: int = 1, grad_itemsize: int = 4) -> CollectiveStats:
    """The port's collective schedule, per device, in the output-size
    convention (a collective counts the bytes of its per-device output):

    * train, per microbatch, forward and backward: an all-gather over
      ``data`` of each ``data``-sharded parameter (output: the leaf with its
      ``data`` axis gathered);
    * train, per step: a reduce-scatter of each ``data``-sharded leaf's
      gradient (output: its shard), and an all-reduce over the batch axes of
      each other leaf's gradient (output: its shard), in ``grad_itemsize``
      bytes an entry (the port accumulates gradients in f32);
    * every kind: an all-reduce over ``model`` of each mixer's and each
      FFN's output (``mixer_outputs`` a pass, ``activation_bytes`` each per
      device), per microbatch, forward and, in training, backward; decode's
      activations are B x 1 tokens.

    A mesh axis of size 1 moves nothing.  MoE all-to-alls are not modelled.
    """
    stats = CollectiveStats()
    data = mesh.shape.get("data", 1)
    batch_total = data * mesh.shape.get("pod", 1)
    model = mesh.shape.get("model", 1)
    passes = 2 if kind == "train" else 1
    if kind == "train":
        for leaf, spec in _pairs([(params, param_specs)]):
            shape = tuple(leaf.shape)
            held = sharding.Sharding(mesh, spec).shard_shape(shape)
            gathered = sharding.Sharding(mesh, _drop(spec, "data"))
            grad_bytes = math.prod(held) * grad_itemsize
            if data > 1 and gathered.shard_shape(shape) != held:
                stats.add("all-gather", gathered.shard_bytes(shape, leaf.dtype),
                          passes * microbatches)
                stats.add("reduce-scatter", grad_bytes)
            elif batch_total > 1:
                stats.add("all-reduce", grad_bytes)
    if model > 1:
        stats.add("all-reduce", activation_bytes, mixer_outputs * passes * microbatches)
    return stats


def analyze(totals, mesh: Mesh, arguments, *, outputs=(),
            collectives: Optional[CollectiveStats] = None,
            peak_flops: float = PEAK_FLOPS_BF16) -> Dict:
    """All roofline numbers of one traced step: ``totals`` from
    ``op_cost`` over the global step, ``arguments`` and ``outputs`` as
    (tree, spec tree) pairs, ``collectives`` from ``collective_schedule``."""
    chips = mesh.size
    coll = collectives or CollectiveStats()
    rl = Roofline(flops=totals.flops / chips, hbm_bytes=totals.hbm_bytes / chips,
                  collective_bytes=float(coll.total_bytes), chips=chips,
                  peak_flops=peak_flops)
    args = sharded_bytes(mesh, arguments)
    temp = int(totals.peak_live_bytes // chips)
    memory = {"argument_bytes": args, "output_bytes": sharded_bytes(mesh, outputs),
              "temp_bytes": temp, "peak_bytes": args + temp}
    return {"roofline": rl, "collectives": coll, "memory": memory}
