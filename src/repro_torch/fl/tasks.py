"""Local-training tasks (port of ``repro.fl.tasks``): the client step of the FL loop.

* ``MaskTask``: the model is a vector theta in [0, 1]^d of Bernoulli
  parameters over a fixed signed-constant network w0.  Local training is
  mirror descent: map theta to scores s = sigma^{-1}(theta), take Adam steps
  on s with the straight-through estimator through the Bernoulli mask draw,
  map back.
* ``CFLTask``: conventional FL.  Local training runs L epochs of Adam on the
  dense weights from the client's model estimate and returns the model
  *delta* (the "gradient" that the compressors quantize).

The whole cohort trains at once: clients are a leading batch axis, which
replaces the reference's ``vmap``.  Both use plain Adam, the reference's
default ``optimizer``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Tuple

import torch

from repro_torch import optim, prng
from repro_torch.core.bernoulli import clip01, inv_sigmoid
from .nets import MLP, accuracy, cross_entropy, flatten_weights


@dataclass(eq=False)
class MaskTask:
    net: MLP
    w0_flat: torch.Tensor       # fixed signed-constant weights, flattened
    unravel: Callable
    x_test: torch.Tensor
    y_test: torch.Tensor
    local_epochs: int = 3
    batch_size: int = 128
    lr: float = 0.1             # paper: Adam in score space with lr 0.1

    @property
    def d(self) -> int:
        return int(self.w0_flat.shape[0])

    @property
    def device(self) -> torch.device:
        return self.w0_flat.device

    def init_theta(self) -> torch.Tensor:
        """The uninformed model: every mask entry on with probability 1/2."""
        return torch.full((self.d,), 0.5, dtype=torch.float32,
                          device=self.device)

    def _score_grad(self, s, xb, yb, mk):
        """d loss / d s for every client: s (n, d), xb (n, bs, ...), mk (n, 2)."""
        s = s.detach().requires_grad_(True)
        prob = torch.sigmoid(s)
        m = prng.bernoulli(mk, prob.detach()).to(torch.float32)
        m_ste = m + prob - prob.detach()  # straight-through
        logits = self.net(xb, self.unravel(self.w0_flat * m_ste))
        (g,) = torch.autograd.grad(cross_entropy(logits, yb).sum(), s)
        return g

    def local_train(self, theta: torch.Tensor, xs: torch.Tensor, ys: torch.Tensor,
                    keys: torch.Tensor) -> torch.Tensor:
        """L epochs of score-space Adam with STE; returns the posteriors q.

        theta (n, d), xs (n, shard, H, W, C), ys (n, shard), keys (n, 2).
        """
        n, shard = ys.shape
        bs = min(self.batch_size, shard)
        steps_per_epoch = max(shard // bs, 1)
        n_steps = self.local_epochs * steps_per_epoch
        kb_km = prng.split(keys, 2)
        batch_idx = prng.randint(kb_km[:, 0], (n_steps, bs), 0, shard)  # (n, steps, bs)
        mks = prng.split(kb_km[:, 1], n_steps)                          # (n, steps, 2)
        opt = optim.adam(self.lr)
        rows = torch.arange(n, device=xs.device)[:, None]
        s = inv_sigmoid(theta)
        st = opt.init(s)
        for k in range(n_steps):
            idx = batch_idx[:, k]
            g = self._score_grad(s, xs[rows, idx], ys[rows, idx], mks[:, k])
            s, st = opt.update(g, s, st)
        return clip01(torch.sigmoid(s))

    def accuracy(self, theta: torch.Tensor) -> torch.Tensor:
        """Accuracy with the expected mask (w * theta) -- low-variance eval --
        as a float32 0-d tensor on the task's device (the fused path's eval
        graph writes it into a device vector; nothing is read back)."""
        return accuracy(self.net, self.unravel(self.w0_flat * theta), self.x_test,
                        self.y_test)

    def evaluate(self, theta: torch.Tensor) -> float:
        """Accuracy with the expected mask (w * theta) -- low-variance eval."""
        return float(self.accuracy(theta))

    def evaluate_sampled(self, theta: torch.Tensor, key: torch.Tensor) -> float:
        """Accuracy with one mask drawn from Bernoulli(theta) under ``key``
        (``jax.random.bernoulli``'s draw, bit for bit)."""
        m = prng.bernoulli(key, clip01(theta)).to(torch.float32)
        return float(accuracy(self.net, self.unravel(self.w0_flat * m), self.x_test,
                              self.y_test))


def make_mask_task(net: MLP, key: torch.Tensor, x_test, y_test, **kw) -> MaskTask:
    w0_flat, unravel = flatten_weights(net.init(key))
    return MaskTask(net=net, w0_flat=w0_flat, unravel=unravel,
                    x_test=x_test, y_test=y_test, **kw)


@dataclass(eq=False)
class CFLTask:
    net: MLP
    unravel: Callable
    d: int
    x_test: torch.Tensor
    y_test: torch.Tensor
    local_epochs: int = 3
    batch_size: int = 128
    local_lr: float = 3e-4

    def _weight_grad(self, w, xb, yb):
        """d loss / d w for every client: w (n, d), xb (n, bs, ...)."""
        w = w.detach().requires_grad_(True)
        logits = self.net(xb, self.unravel(w))
        (g,) = torch.autograd.grad(cross_entropy(logits, yb).sum(), w)
        return g

    def local_train(self, theta: torch.Tensor, xs: torch.Tensor, ys: torch.Tensor,
                    keys: torch.Tensor) -> torch.Tensor:
        """L epochs of Adam from each client's estimate; returns the deltas
        ``theta - w_fin`` (the negative update direction).

        theta (n, d), xs (n, shard, H, W, C), ys (n, shard), keys (n, 2).
        The batches are ``randint(key, (n_steps, bs), 0, shard)`` on the
        client's key itself (``MaskTask`` splits it first).
        """
        n, shard = ys.shape
        bs = min(self.batch_size, shard)
        steps_per_epoch = max(shard // bs, 1)
        n_steps = self.local_epochs * steps_per_epoch
        batch_idx = prng.randint(keys, (n_steps, bs), 0, shard)   # (n, steps, bs)
        opt = optim.adam(self.local_lr)
        rows = torch.arange(n, device=xs.device)[:, None]
        w = theta
        st = opt.init(w)
        for k in range(n_steps):
            idx = batch_idx[:, k]
            g = self._weight_grad(w, xs[rows, idx], ys[rows, idx])
            w, st = opt.update(g, w, st)
        return theta - w

    def accuracy(self, theta: torch.Tensor) -> torch.Tensor:
        """Test accuracy as a float32 0-d tensor (the fused path's form)."""
        return accuracy(self.net, self.unravel(theta), self.x_test, self.y_test)

    def evaluate(self, theta: torch.Tensor) -> float:
        return float(self.accuracy(theta))


def make_cfl_task(net: MLP, key: torch.Tensor, x_test, y_test,
                  **kw) -> Tuple[CFLTask, torch.Tensor]:
    """A ``CFLTask`` and its initial model ``theta0``: the network's
    Kaiming-normal weights drawn from ``key``, flattened."""
    w0_flat, unravel = flatten_weights(net.init(key))
    task = CFLTask(net=net, unravel=unravel, d=int(w0_flat.shape[0]),
                   x_test=x_test, y_test=y_test, **kw)
    return task, w0_flat
