"""Sharding rules: logical parameter and activation axes -> mesh axes (port
of ``repro.models.sharding``).

The scheme is the reference's (MaxText-style):

* ``model`` axis: attention heads (the flattened q/k/v/o output dim), FFN
  hidden, experts, vocab;
* ``data`` axis (+ ``pod``): batch; and the stacked-layer dim of the
  pattern's parameters (FSDP/ZeRO-3 style);
* decode caches: batch on ``data``, the merged kv-feature dim on ``model``.

A spec is ``P``, a tuple of mesh-axis entries, so it compares equal to the
reference's ``PartitionSpec`` taken as a tuple.  The port runs on one card:
specs are metadata that the dry run reads to give per-device bytes, and
``constraint`` is the identity (the layers do not call it).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from repro_torch.launch.mesh import Mesh


class P(tuple):
    """A partition spec: one entry per leading dim, each None, a mesh axis
    name, or a tuple of names; missing trailing entries are None."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


def is_spec(t) -> bool:
    return isinstance(t, P)


_MESH: Optional[Mesh] = None


def set_mesh(mesh: Optional[Mesh]) -> None:
    global _MESH
    _MESH = mesh


def get_mesh() -> Optional[Mesh]:
    return _MESH


def has_axis(name: str) -> bool:
    return _MESH is not None and name in _MESH.axis_names


def axis_size(name: str, mesh: Optional[Mesh] = None) -> int:
    """The size of a mesh axis (1 if the mesh, the active one by default,
    has no such axis)."""
    mesh = mesh or _MESH
    if mesh is None or name not in mesh.axis_names:
        return 1
    return mesh.shape[name]


def batch_axes():
    """Mesh axes the global batch is split over."""
    if has_axis("pod"):
        return ("pod", "data")
    return "data"


def _axis_prod(entry, mesh: Optional[Mesh] = None) -> int:
    if entry is None:
        return 1
    names = entry if isinstance(entry, tuple) else (entry,)
    return math.prod(axis_size(a, mesh) for a in names)


def sanitize(shape, spec: P, mesh: Optional[Mesh] = None) -> P:
    """Drop spec entries whose mesh axes do not divide the dim (e.g. the
    batch axis of the batch-1 long-context shape)."""
    entries = list(spec) + [None] * (len(shape) - len(spec))
    fixed = [e if (e is None or dim % _axis_prod(e, mesh) == 0) else None
             for dim, e in zip(shape, entries)]
    return P(*fixed)


def constraint(x, spec: P):
    """The identity: the port places nothing (kept for the reference's API)."""
    return x


# ---------------------------------------------------------------------------
# Param specs; the layers' spec builders sit beside their inits.
# ---------------------------------------------------------------------------

def spec_embed() -> P:       # (vocab, d)
    return P("model", None)


def spec_head() -> P:        # (d, vocab)
    return P(None, "model")


def spec_stacked(inner: P) -> P:
    """Stacked-layer leading dim -> FSDP ('data') sharding."""
    return P("data", *inner)


class Sharding(NamedTuple):
    """A spec on a mesh: what one device holds of a global array."""
    mesh: Mesh
    spec: P

    def shard_shape(self, global_shape) -> tuple:
        """The per-device shape, the spec sanitized against ``global_shape``."""
        spec = sanitize(global_shape, self.spec, self.mesh)
        return tuple(dim // _axis_prod(e, self.mesh) for dim, e in zip(global_shape, spec))

    def shard_bytes(self, global_shape, dtype: torch.dtype) -> int:
        return math.prod(self.shard_shape(global_shape)) * dtype.itemsize


def sharding_for(spec: P) -> Optional[Sharding]:
    """The spec on the active mesh (None without one)."""
    if _MESH is None:
        return None
    return Sharding(_MESH, spec)
