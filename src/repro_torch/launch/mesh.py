"""The logical device mesh and the H100's constants (port of
``repro.launch.mesh``).

A ``Mesh`` here is names and sizes only: ``axis_names``, a ``shape``
mapping and ``size``.  That is all that ``models.sharding`` and the dry run
read.  It places nothing and starts no process group: the port runs on one
card, and a ``torch.distributed`` mesh of one device would place nothing
differently.  The production meshes are the reference's, so that the dry
run gives per-device figures for the same layouts.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Tuple


@dataclass(frozen=True)
class Mesh:
    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's production meshes: (16, 16) ``("data", "model")``;
    two pods (2, 16, 16) ``("pod", "data", "model")``."""
    if multi_pod:
        return Mesh(("pod", "data", "model"), (2, 16, 16))
    return Mesh(("data", "model"), (16, 16))


def make_host_mesh() -> Mesh:
    """The (1, 1) mesh: the one card."""
    return Mesh(("data", "model"), (1, 1))


# H100 SXM per-device constants for the roofline (NVIDIA H100 data sheet).
PEAK_FLOPS_BF16 = 989e12      # FLOP/s, bf16 tensor cores, dense
PEAK_FLOPS_F32 = 67e12        # FLOP/s, f32 outside the tensor cores
PEAK_FLOPS_TF32 = 495e12      # FLOP/s, TF32 tensor cores, dense
HBM_BW = 3.35e12              # bytes/s, HBM3
# Interconnect, bytes/s per direction, for the collective term: a card's
# 400 Gb/s NDR InfiniBand port, 50 GB/s.  A (16, 16) mesh spans 32 nodes
# of 8 cards, so its collectives cross InfiniBand; inside a node each of
# an H100's 18 NVLink 4 links gives 25 GB/s (450 GB/s in all).  The
# reference uses one TPU ICI link's rate the same way.
LINK_BW = 50e9
