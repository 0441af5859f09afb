"""Frozen copy of the FL inputs: the synthetic classes, the iid partition
and the frozen signed-constant MLP weights, drawn from one seed as the
port's quickstart draws them from 0.

Each class has a smoothed unit-std Gaussian template; a sample is its
template plus ``noise`` times a standard normal.  The partition draws each
client's shard with replacement.  A weight matrix is the sign of a normal
draw times the Kaiming std ``sqrt(2 / fan_in)``.
"""
from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from . import threefry as tf


def _smooth_field(keys: torch.Tensor, hw: int, smooth: int = 3) -> torch.Tensor:
    raw = tf.normal(keys, (hw + 2 * smooth, hw + 2 * smooth))
    width = 2 * smooth + 1
    box = torch.ones(1, 1, width, width, device=keys.device) / width ** 2
    sm = F.conv2d(raw[:, None], box)[:, 0]
    std = sm.reshape(sm.shape[0], -1).std(dim=-1, correction=0)
    sm = sm / (std[:, None, None] + 1e-6)
    return sm[:, :hw, :hw]


def synthetic(k: torch.Tensor, *, n_train: int, n_test: int, hw: int, noise: float,
              n_classes: int = 10):
    """((x_train, y_train), (x_test, y_test)); x is (N, hw, hw, 1) f32."""
    kt, ktr, kte = tf.split(k, 3)
    templates = _smooth_field(tf.split(kt, n_classes), hw)
    templates = templates.reshape(n_classes, 1, hw, hw).permute(0, 2, 3, 1)

    def sample(kk, n):
        ky, kn = tf.split(kk, 2)
        y = tf.randint(ky, (n,), 0, n_classes)
        x = templates[y] + noise * tf.normal(kn, (n, hw, hw, 1))
        return x.to(torch.float32).contiguous(), y

    return sample(ktr, n_train), sample(kte, n_test)


def partition_iid(k: torch.Tensor, x: torch.Tensor, y: torch.Tensor, n_clients: int,
                  shard: int):
    """``(n_clients, shard, ...)`` shards drawn with replacement."""
    idx = tf.randint(k, (n_clients, shard), 0, x.shape[0])
    return x[idx], y[idx]


def signed_constant(k: torch.Tensor, dims) -> torch.Tensor:
    """The MLP's frozen weights, each ``(d_in, d_out)`` matrix row-major,
    concatenated in layer order: ``(d,)`` f32."""
    shapes = list(zip(dims[:-1], dims[1:]))
    keys = tf.split(k, len(shapes))
    flat = [torch.sign(tf.normal(kk, s)) * math.sqrt(2.0 / s[0]) for kk, s in zip(keys, shapes)]
    return torch.cat([w.reshape(-1) for w in flat])


def make_inputs(seed: int, cfg: Dict, device) -> Dict[str, torch.Tensor]:
    """Everything a job reads, from ``seed``: shards, test set, frozen weights."""
    k = tf.key(seed, device)
    (xtr, ytr), (xte, yte) = synthetic(k, n_train=cfg["n_train"], n_test=cfg["n_test"],
                                       hw=cfg["hw"], noise=cfg["noise"])
    n = cfg["n_clients"]
    xs, ys = partition_iid(tf.fold_in(k, 1), xtr, ytr, n, cfg["n_train"] // n)
    dims = [cfg["hw"] * cfg["hw"], *cfg["widths"], cfg["n_classes"]]
    w0 = signed_constant(tf.fold_in(k, 2), dims)
    return {"x": xs, "y": ys, "x_test": xte, "y_test": yte, "w0": w0, "dims": dims}
