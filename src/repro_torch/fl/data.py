"""Synthetic federated datasets and iid partitioning (port of ``repro.fl.data``).

Each class c has a smooth random template T_c (a low-frequency Gaussian
field); samples are T_c + noise * N(0, 1).  The draws use the reference's
threefry streams (``repro_torch.prng``), so labels and partitions are
identical to the reference's and pixel values agree to float tolerance
(``normal`` goes through torch's ``erfinv``; the smoothing sums in another
order).  The Dirichlet partition seeds numpy from the same threefry draw as
the reference and makes the same numpy draws, so its shards are the
reference's.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
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


def partition_dirichlet(key: torch.Tensor, ds: Dataset, n_clients: int, shard_size: int,
                        alpha: float = 0.1, n_classes: int = 10) -> Dataset:
    """Heterogeneous shards: each client's class mix ~ Dirichlet(alpha).

    numpy's ``default_rng`` is seeded with ``randint(key, (), 0, 2**31 - 1)``
    and draws, client by client, the class mix, the class counts, the
    samples of each class (with replacement) and a shuffle, as the
    reference does.  ``(n_clients, shard, ...)`` on ``ds``'s device.
    """
    np_rng = np.random.default_rng(int(prng.randint(key, (), 0, 2**31 - 1)))
    y = ds.y.cpu().numpy()
    by_class = [np.nonzero(y == c)[0] for c in range(n_classes)]
    sels = []
    for _ in range(n_clients):
        probs = np_rng.dirichlet(alpha * np.ones(n_classes))
        # guard against empty classes
        probs = np.array([p if len(by_class[c]) else 0.0 for c, p in enumerate(probs)])
        probs = probs / probs.sum()
        counts = np_rng.multinomial(shard_size, probs)
        sel = np.concatenate([np_rng.choice(by_class[c], size=k, replace=True)
                              for c, k in enumerate(counts) if k > 0])
        np_rng.shuffle(sel)
        sels.append(sel)
    idx = torch.as_tensor(np.stack(sels), device=ds.x.device)
    return Dataset(x=ds.x[idx], y=ds.y[idx])
