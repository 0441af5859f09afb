"""Checkpointing: save/restore nested trees of arrays (port of ``repro.checkpoint``).

The reference's self-contained binary format, byte for byte and without
``jax``: ``MAGIC``, a little-endian u64 header length, a JSON header (the
tree structure as a string, a ``structure`` descriptor, the step, and
dtype/shape per leaf), then the raw little-endian leaf buffers.  Files
written by either package load in the other.

A tree is nested dicts, lists and tuples whose leaves are numpy arrays,
numbers or torch tensors (copied to the host); ``None`` is no leaf.  Leaves
are ordered as ``jax.tree.leaves`` orders them -- dict keys sorted, lists
and tuples in order -- so the leaf table and the descriptor are the
reference's.

Crash safety: ``save`` writes to a unique temp file, fsyncs it, and
atomically renames it over the target (a crash mid-save can never shadow a
good checkpoint with a torn one), and ``latest_step`` / ``latest``
*validate* candidates -- magic, parseable header, complete payload --
warning on and skipping corrupt or partially-written files instead of
choosing them.

Two addressing modes:

* single file -- ``save(path, tree, step=)`` / ``restore(path, like)`` /
  ``load(path)``: one checkpoint, overwritten in place (atomically);
* step directory -- ``save_step(dir, tree, step)`` / ``latest(dir)``: one
  ``ckpt_<step>.repro`` file per step, so an interrupted run resumes from
  the newest *valid* step (the FL engine's ``resume_from=``).

``load`` needs no reference tree: it rebuilds the saved nesting from the
header's ``structure`` descriptor, with numpy leaves (0-d for saved Python
scalars).  ``restore(path, like)`` rebuilds the structure of ``like`` with
torch tensors on each reference leaf's device; the reference's re-sharding
onto a mesh has no counterpart here and is refused.
"""
from __future__ import annotations

import json
import os
import struct
import warnings
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

MAGIC = b"REPROCKPT1"
_STEP_FMT = "ckpt_{step:08d}.repro"


class CheckpointError(AssertionError):
    """A checkpoint file is torn or structurally invalid (loud by design,
    like :class:`repro_torch.core.bitmeter.ReconcileError`)."""


# ---------------------------------------------------------------------------
# Tree flattening in jax.tree's order, and the structure descriptor.
# ---------------------------------------------------------------------------


def _leaves(tree) -> List[Any]:
    """The leaves of ``tree`` in ``jax.tree.leaves`` order."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in _leaves(v)]
    if tree is None:
        return []
    return [tree]


def _treedef(tree) -> str:
    """The tree's structure as ``str(jax.tree.structure(tree))`` prints it."""
    def one(node):
        if isinstance(node, dict):
            return "{" + ", ".join(f"{k!r}: {one(node[k])}" for k in sorted(node)) + "}"
        if isinstance(node, list):
            return "[" + ", ".join(one(v) for v in node) + "]"
        if isinstance(node, tuple):
            inner = ", ".join(one(v) for v in node)
            return f"({inner},)" if len(node) == 1 else f"({inner})"
        return "None" if node is None else "*"
    return f"PyTreeDef({one(tree)})"


def _describe(tree, counter) -> Any:
    if isinstance(tree, dict):
        return {"kind": "dict",
                "items": [[k, _describe(v, counter)] for k, v in sorted(tree.items())]}
    if isinstance(tree, (list, tuple)):
        kind = "list" if isinstance(tree, list) else "tuple"
        return {"kind": kind, "items": [_describe(v, counter) for v in tree]}
    if tree is None:
        return {"kind": "none"}
    idx = counter[0]
    counter[0] += 1
    return {"kind": "leaf", "index": idx}


def _rebuild(desc, leaves) -> Any:
    kind = desc["kind"]
    if kind == "dict":
        return {k: _rebuild(v, leaves) for k, v in desc["items"]}
    if kind == "list":
        return [_rebuild(v, leaves) for v in desc["items"]]
    if kind == "tuple":
        return tuple(_rebuild(v, leaves) for v in desc["items"])
    if kind == "none":
        return None
    return leaves[desc["index"]]


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


# ---------------------------------------------------------------------------
# Save / restore.
# ---------------------------------------------------------------------------


def save(path: str, tree, *, step: Optional[int] = None) -> None:
    leaves = [_host(leaf) for leaf in _leaves(tree)]
    counter = [0]
    structure = _describe(tree, counter)
    header = {
        "treedef": _treedef(tree),
        "structure": structure if counter[0] == len(leaves) else None,
        "step": step,
        "leaves": [{"dtype": str(leaf.dtype), "shape": list(leaf.shape)} for leaf in leaves],
    }
    hdr = json.dumps(header).encode()
    # Unique temp name (pid) so two writers cannot tear each other's temp;
    # fsync file + directory so the rename is durable before it is visible.
    tmp = f"{path}.tmp.{os.getpid()}"
    dirname = os.path.dirname(os.path.abspath(path))
    os.makedirs(dirname, exist_ok=True)
    with open(tmp, "wb") as f:
        f.write(MAGIC)
        f.write(struct.pack("<Q", len(hdr)))
        f.write(hdr)
        for leaf in leaves:
            f.write(np.ascontiguousarray(leaf).tobytes())
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    try:
        dfd = os.open(dirname, os.O_RDONLY)
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)
    except OSError:  # directory fsync is best-effort (not all FSes allow it)
        pass


def _read_header(f) -> dict:
    magic = f.read(len(MAGIC))
    if magic != MAGIC:
        raise CheckpointError("not a repro checkpoint (bad magic)")
    raw = f.read(8)
    if len(raw) != 8:
        raise CheckpointError("truncated header length")
    (hlen,) = struct.unpack("<Q", raw)
    hdr = f.read(hlen)
    if len(hdr) != hlen:
        raise CheckpointError("truncated header")
    try:
        header = json.loads(hdr)
    except ValueError as e:
        raise CheckpointError(f"unparseable header: {e}") from e
    if not isinstance(header, dict) or "leaves" not in header:
        raise CheckpointError("header missing leaf table")
    return header


def _payload_bytes(header) -> int:
    total = 0
    for meta in header["leaves"]:
        n = int(np.prod(meta["shape"])) if meta["shape"] else 1
        total += n * np.dtype(meta["dtype"]).itemsize
    return total


def _read_leaves(f, header):
    out = []
    for meta in header["leaves"]:
        dt = np.dtype(meta["dtype"])
        n = int(np.prod(meta["shape"])) if meta["shape"] else 1
        buf = f.read(n * dt.itemsize)
        if len(buf) != n * dt.itemsize:
            raise CheckpointError("truncated leaf payload")
        out.append(np.frombuffer(buf, dt).reshape(meta["shape"]))
    return out


def restore(path: str, like, *, mesh=None, specs=None):
    """Restore into the structure of ``like``: each leaf a tensor on the
    device of ``like``'s leaf (a tensor), or on the CPU.  ``mesh`` /
    ``specs`` (the reference's re-sharding) are refused by name."""
    if mesh is not None or specs is not None:
        raise ValueError("restore(mesh=, specs=) re-shards onto a JAX device mesh; "
                         "the torch port has no mesh: restore(path, like) only")
    with open(path, "rb") as f:
        header = _read_header(f)
        out_leaves = _read_leaves(f, header)
    ref_leaves = _leaves(like)
    if len(ref_leaves) != len(out_leaves):
        raise CheckpointError(
            f"checkpoint has {len(out_leaves)} leaves, reference tree {len(ref_leaves)}")
    tensors = []
    for ref, val in zip(ref_leaves, out_leaves):
        if tuple(np.shape(ref)) != tuple(val.shape):
            raise CheckpointError(
                f"leaf shape mismatch: checkpoint {tuple(val.shape)} vs "
                f"reference {tuple(np.shape(ref))}")
        dev = ref.device if isinstance(ref, torch.Tensor) else "cpu"
        tensors.append(torch.from_numpy(val.copy()).to(dev))
    counter = [0]
    return _rebuild(_describe(like, counter), tensors)


def load(path: str) -> Tuple[Any, Optional[int]]:
    """Load ``(tree, step)`` with no reference tree (self-describing v2).

    Leaves come back as numpy arrays (0-d for saved Python scalars);
    callers convert to tensors where needed.  Raises
    :class:`CheckpointError` on files saved without a structure descriptor
    or on any corruption.
    """
    with open(path, "rb") as f:
        header = _read_header(f)
        if header.get("structure") is None:
            raise CheckpointError(
                f"{path} has no structure descriptor; use restore(path, like) "
                "with a reference tree")
        leaves = _read_leaves(f, header)
    return _rebuild(header["structure"], leaves), header.get("step")


# ---------------------------------------------------------------------------
# Validation + latest-step discovery (skip torn files, loudly).
# ---------------------------------------------------------------------------


def validate(path: str) -> Tuple[bool, Optional[int], str]:
    """Cheap structural check: ``(ok, step, reason)``.

    Verifies magic, header parse, and that the file carries the complete
    leaf payload the header promises -- the failure modes of a crash
    mid-write (never with the atomic ``save``, but a non-atomic writer or a
    copied partial file still must not be chosen).
    """
    try:
        size = os.path.getsize(path)
        with open(path, "rb") as f:
            header = _read_header(f)
            body_start = f.tell()
        expected = body_start + _payload_bytes(header)
        if size < expected:
            return False, header.get("step"), (
                f"truncated payload ({size} bytes, header promises {expected})")
        return True, header.get("step"), ""
    except (OSError, CheckpointError, ValueError) as e:
        return False, None, str(e)


def latest_step(path: str) -> Optional[int]:
    """Step recorded in ``path``, or None if absent or corrupt (warns)."""
    if not os.path.exists(path):
        return None
    ok, step, reason = validate(path)
    if not ok:
        warnings.warn(f"skipping corrupt checkpoint {path}: {reason}",
                      RuntimeWarning, stacklevel=2)
        return None
    return step


def step_path(directory: str, step: int) -> str:
    return os.path.join(directory, _STEP_FMT.format(step=int(step)))


def save_step(directory: str, tree, step: int) -> str:
    """Save one per-step checkpoint file under ``directory``."""
    path = step_path(directory, step)
    save(path, tree, step=int(step))
    return path


def latest(directory: str) -> Tuple[Optional[str], Optional[int]]:
    """Newest *valid* per-step checkpoint in ``directory``.

    Scans ``ckpt_*.repro`` files newest-first, warns on and skips any
    corrupt or partial candidate, and returns ``(path, step)`` of the first
    valid one -- ``(None, None)`` when the directory holds none.
    """
    if not os.path.isdir(directory):
        return None, None
    names = sorted((n for n in os.listdir(directory)
                    if n.startswith("ckpt_") and n.endswith(".repro")), reverse=True)
    for name in names:
        path = os.path.join(directory, name)
        ok, step, reason = validate(path)
        if not ok:
            warnings.warn(f"skipping corrupt checkpoint {path}: {reason}",
                          RuntimeWarning, stacklevel=2)
            continue
        if step is None:  # step files always record their step
            warnings.warn(f"skipping step-less checkpoint {path}",
                          RuntimeWarning, stacklevel=2)
            continue
        return path, int(step)
    return None, None
