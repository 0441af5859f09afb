"""Synthetic federated datasets and iid partitioning (port of ``repro.fl.data``).

Each class c has a smooth random template T_c (a low-frequency Gaussian
field); samples are T_c + noise * N(0, 1).  The draws use the reference's
threefry streams (``repro_torch.prng``), so labels and partitions are
identical to the reference's and pixel values agree to float tolerance
(``normal`` goes through torch's ``erfinv``; the smoothing sums in another
order).  The Dirichlet partition comes with a later slice.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from repro_torch import prng, resolve_device


class Dataset(NamedTuple):
    x: torch.Tensor  # (N, H, W, C) float32 -- the reference's NHWC layout
    y: torch.Tensor  # (N,) int64


def _smooth_field(keys: torch.Tensor, hw: int, smooth: int = 3) -> torch.Tensor:
    """One smoothed, unit-std field per key: ``(K, 2)`` -> ``(K, hw, hw)``."""
    raw = prng.normal(keys, (hw + 2 * smooth, hw + 2 * smooth))
    width = 2 * smooth + 1
    k = torch.ones(1, 1, width, width, device=keys.device) / width ** 2
    sm = F.conv2d(raw[:, None], k)[:, 0]  # "valid"; the box kernel is symmetric
    std = sm.reshape(sm.shape[0], -1).std(dim=-1, correction=0)
    sm = sm / (std[:, None, None] + 1e-6)
    return sm[:, :hw, :hw]


def make_synthetic(key: torch.Tensor, *, n_train: int = 5000, n_test: int = 1000,
                   n_classes: int = 10, hw: int = 14, channels: int = 1,
                   noise: float = 0.9, device="cuda") -> Tuple[Dataset, Dataset]:
    key = key.to(resolve_device(device))
    kt, ktr, kte = prng.split(key, 3)
    templates = _smooth_field(prng.split(kt, n_classes * channels), hw)
    templates = templates.reshape(n_classes, channels, hw, hw).permute(0, 2, 3, 1)

    def sample(k, n):
        ky, kn = prng.split(k, 2)
        y = prng.randint(ky, (n,), 0, n_classes)
        x = templates[y] + noise * prng.normal(kn, (n, hw, hw, channels))
        return Dataset(x=x.to(torch.float32).contiguous(), y=y)

    return sample(ktr, n_train), sample(kte, n_test)


def partition_iid(key: torch.Tensor, ds: Dataset, n_clients: int,
                  shard_size: int) -> Dataset:
    """Equal shards drawn with replacement: ``(n_clients, shard, ...)``."""
    n = ds.x.shape[0]
    idx = prng.randint(key.to(ds.x.device), (n_clients, shard_size), 0, n)
    return Dataset(x=ds.x[idx], y=ds.y[idx])
