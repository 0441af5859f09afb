"""Classifier networks for the FL experiments (port of ``repro.fl.nets``).

Bias-free MLP and CNN with the *signed-constant* initialization of
Ramanujan et al. (2020): w = sign(n) * std_kaiming.  A network's frozen
weights are module buffers; the MLP's ``forward`` also takes explicit
weights, batched over leading axes (one set per client), which replaces the
reference's ``vmap`` over clients.
"""
from __future__ import annotations

import math
from typing import Callable, List, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from repro_torch import prng, resolve_device


class _FrozenNet(nn.Module):
    """Frozen weights as buffers ``w0, w1, ...``, one per ``(shape, fan_in)``
    of ``draws``, drawn by ``init`` as the reference's ``init`` draws them."""

    def _register(self, draws: List[Tuple[Tuple[int, ...], int]], signed_constant: bool,
                  device) -> None:
        self.draws, self.signed_constant = draws, signed_constant
        dev = resolve_device(device)
        for i, (shape, _) in enumerate(draws):
            self.register_buffer(f"w{i}", torch.zeros(shape, device=dev))

    def frozen_weights(self) -> List[torch.Tensor]:
        return [getattr(self, f"w{i}") for i in range(len(self.draws))]

    @torch.no_grad()
    def init(self, key: torch.Tensor) -> List[torch.Tensor]:
        """Draw the frozen weights from ``key`` (as the reference's ``init``).

        Kaiming-scaled normals, or their signs times the Kaiming std when
        ``signed_constant`` (bit-exact with the reference: the sign of the
        normal draw does not depend on ``erfinv``'s rounding).
        """
        keys = prng.split(key.to(self.w0.device), len(self.draws))
        for k, (shape, fan_in), w in zip(keys, self.draws, self.frozen_weights()):
            n = prng.normal(k, shape)
            std = math.sqrt(2.0 / fan_in)
            w.copy_(torch.sign(n) * std if self.signed_constant else n * std)
        return self.frozen_weights()


class MLP(_FrozenNet):
    """ReLU MLP ``dims[0] -> ... -> dims[-1]`` on flattened NHWC inputs."""

    def __init__(self, dims: Sequence[int], signed_constant: bool = False,
                 device="cuda"):
        super().__init__()
        self.dims = tuple(int(d) for d in dims)
        self._register([((a, b), a) for a, b in self.shapes], signed_constant, device)

    @property
    def shapes(self) -> List[Tuple[int, int]]:
        return list(zip(self.dims[:-1], self.dims[1:]))

    def forward(self, x: torch.Tensor,
                weights: Optional[List[torch.Tensor]] = None) -> torch.Tensor:
        """Logits.  ``weights`` default to the frozen buffers; with a leading
        batch axis ``(n, a, b)`` each, ``x`` is ``(n, bs, H, W, C)``."""
        weights = self.frozen_weights() if weights is None else weights
        nbatch = weights[0].dim() - 2
        h = x.reshape(*x.shape[:nbatch + 1], -1)
        for w in weights[:-1]:
            h = F.relu(torch.matmul(h, w))
        return torch.matmul(h, weights[-1])


class CNN(_FrozenNet):
    """Conv(3x3, SAME) + ReLU + MaxPool(2x2, VALID) blocks, then a dense
    ReLU head; bias-free.  The reference's layouts: HWIO conv weights,
    ``(d_in, d_out)`` dense weights and NHWC inputs; the layout is
    converted at the call (torch's convolution is NCHW/OIHW)."""

    def __init__(self, hw: int = 14, channels: int = 1, n_classes: int = 10,
                 conv_widths: Sequence[int] = (32, 64), dense_widths: Sequence[int] = (128,),
                 signed_constant: bool = False, device="cuda"):
        super().__init__()
        final_hw = hw // (2 ** len(conv_widths))
        assert final_hw >= 1, "too many pools for input size"
        self.n_conv = len(conv_widths)
        draws, cin = [], channels
        for w in conv_widths:
            draws.append(((3, 3, cin, w), 3 * 3 * cin))
            cin = w
        din = final_hw * final_hw * cin
        for w in dense_widths:
            draws.append(((din, w), din))
            din = w
        draws.append(((din, n_classes), din))
        self._register(draws, signed_constant, device)

    def forward(self, x: torch.Tensor,
                weights: Optional[List[torch.Tensor]] = None) -> torch.Tensor:
        """Logits of ``x`` (N, H, W, C); ``weights`` default to the buffers."""
        weights = self.frozen_weights() if weights is None else weights
        h = x.permute(0, 3, 1, 2)                                    # NHWC -> NCHW
        for w in weights[:self.n_conv]:
            h = F.conv2d(h, w.permute(3, 2, 0, 1), padding=1)        # HWIO -> OIHW
            h = F.max_pool2d(F.relu(h), 2)
        h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)           # flattened as NHWC
        for w in weights[self.n_conv:-1]:
            h = F.relu(h @ w)
        return h @ weights[-1]


def make_cnn(hw: int = 14, channels: int = 1, n_classes: int = 10,
             conv_widths: Sequence[int] = (32, 64), dense_widths: Sequence[int] = (128,),
             signed_constant: bool = False, device="cuda") -> CNN:
    return CNN(hw, channels, n_classes, conv_widths, dense_widths, signed_constant, device)


def make_mlp(in_dim: int, widths: Sequence[int] = (256, 256), n_classes: int = 10,
             signed_constant: bool = False, device="cuda") -> MLP:
    return MLP([in_dim, *widths, n_classes], signed_constant=signed_constant,
               device=device)


def flatten_weights(weights: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, Callable]:
    """``ravel_pytree`` order: each matrix row-major, concatenated in list order.

    ``unravel`` accepts leading batch axes: ``(..., d)`` -> list of ``(..., a, b)``.
    """
    shapes = [tuple(w.shape) for w in weights]
    sizes = [math.prod(s) for s in shapes]
    flat = torch.cat([w.reshape(-1) for w in weights])

    def unravel(v: torch.Tensor) -> List[torch.Tensor]:
        parts = torch.split(v, sizes, dim=-1)
        return [t.reshape(*v.shape[:-1], *s) for t, s in zip(parts, shapes)]

    return flat, unravel


def cross_entropy(logits: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy over the sample axis (batched over leading axes)."""
    logp = F.log_softmax(logits, dim=-1)
    return -torch.take_along_dim(logp, y[..., None], dim=-1)[..., 0].mean(dim=-1)


@torch.no_grad()
def accuracy(net: MLP, weights, x: torch.Tensor, y: torch.Tensor,
             batch: int = 1000) -> torch.Tensor:
    """Mean top-1 accuracy as a float32 scalar tensor (chunks of ``batch`` rows).

    Scales the count by the float32 reciprocal of n, as the reference does.
    """
    n = x.shape[0]
    correct = sum((torch.argmax(net(x[i:i + batch], weights), -1) == y[i:i + batch])
                  .to(torch.float32).sum() for i in range(0, n, batch))
    return correct * torch.full((), 1.0 / n, dtype=torch.float32, device=x.device)
