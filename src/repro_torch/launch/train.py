"""Trainer: the train step with microbatch gradient accumulation (port of
``repro.launch.train``).

``make_train_step(model, ...)`` builds the step function; ``Trainer`` holds
the parameters, the optimizer state and the key schedule.  The parameters
are the reference's tree, ``{embed, final_norm, head, prefix, pattern}``
with each pattern leaf stacked over the pattern's ``n_rep`` repetitions
(``convert.stack_model_params``); the losses read per-layer views of it
(``convert.params_view``), so autograd returns the gradients in the
reference's layout and the optimizer and the sign compression see the
reference's leaves, in ``jax.tree`` order.

Optimizer policy: Adam for models below ``ADAFACTOR_THRESHOLD`` parameters,
factored second moments (``optim.adafactor_like``) above.

BiCompFL-at-scale (``grad_compression="stochastic_sign"``): the averaged
gradient of each leaf is stochastically sign-quantized (Q_s with K = mean
|g|, a Bernoulli(sigmoid(g / K)) sign per entry, keyed per leaf) -- the
paper's uplink structure inside the trainer.

Spans (``repro_torch.spans``): ``train.step`` is ``Trainer.step``; inside
it ``train.fwd_bwd`` is one microbatch's loss, gradients and their
accumulation, ``train.sign`` the stochastic sign over every leaf,
``train.update`` the optimizer and ``train.sync`` the loss read back.

Sharding metadata, as the reference's: ``opt_state_specs`` and
``batch_specs`` give the partition specs of the optimizer state and the
batch, ``build_setup`` everything the dry run traces (the model, the
optimizer, the parameters and optimizer state on the ``meta`` device with
their FSDP specs, the step function), ``shardings_for`` a spec tree on a
mesh.  The port trains on one card: ``Trainer`` takes a mesh and refuses
one of more than one device.  On ``meta`` parameters the step traces one
microbatch and counts it ``microbatches`` times (``kernels.cost.repeat``).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch import convert, optim, prng, resolve_device, spans
from repro_torch.kernels import cost
from repro_torch.launch.mesh import Mesh
from repro_torch.models import sharding, transformer as T
from repro_torch.models.config import ArchConfig
from repro_torch.models.sharding import P, is_spec
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

ADAFACTOR_THRESHOLD = 100e9
# Elements per threefry range of the sign draw: the int64 threefry keeps
# ~10 temporaries of its range alive, ~1.3 GB at this size, whatever the
# leaf's size (a stacked full-width leaf holds 10^8-10^9 entries).
SIGN_DRAW_RANGE = 1 << 24


def choose_optimizer(cfg: ArchConfig, lr: float = 1e-4) -> Tuple[str, optim.Optimizer]:
    if cfg.params_count() > ADAFACTOR_THRESHOLD:
        return "adafactor", optim.adafactor_like(lr)
    return "adam", optim.adam(lr)


def _spec_entries(spec: P, ndim: int):
    return list(spec) + [None] * (ndim - len(spec))


def opt_state_specs(opt_name: str, params, param_specs):
    """Spec tree matching the optimizer state's structure: Adam's
    ``AdamState(mu, nu, step)``, momentum's velocities, adafactor's per-leaf
    (row, col) factor pairs (a vector keeps its spec), sgd's ``()``."""
    if opt_name == "adam":
        return optim.AdamState(mu=param_specs, nu=param_specs, step=P())
    if opt_name == "sgd":
        return ()
    if opt_name == "momentum":
        return param_specs
    if opt_name == "adafactor":
        flat_specs = tree_leaves(param_specs, is_leaf=is_spec)
        out = []
        for leaf, spec in zip(tree_leaves(params), flat_specs):
            ent = _spec_entries(spec, leaf.dim())
            out.append((P(*ent[:-1]), P(*(ent[:-2] + ent[-1:]))) if leaf.dim() >= 2
                       else P(*ent))
        return tree_unflatten(params, out)
    raise ValueError(opt_name)


def batch_specs(cfg: ArchConfig, batch_tree) -> Dict[str, P]:
    """Each input's leading (batch) dim over the batch axes."""
    b = sharding.batch_axes()
    return {name: P(b, *([None] * (leaf.dim() - 1))) for name, leaf in batch_tree.items()}


# ---------------------------------------------------------------------------
# The step function
# ---------------------------------------------------------------------------


def make_loss_fn(model: T.Model, *, kv_chunk: int = 1024) -> Callable:
    """(stacked params, batch) -> loss: ``lm_loss``, or ``encoder_loss``
    for an encoder-only config."""
    loss = T.lm_loss if model.cfg.causal else T.encoder_loss

    def loss_fn(params, batch):
        return loss(model, convert.params_view(model, params), batch, kv_chunk=kv_chunk)

    return loss_fn


def _bernoulli(key: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """``prng.bernoulli(key, p)`` drawn in ranges of ``SIGN_DRAW_RANGE``
    flat positions through ``prng.uniform_at``: the same bits (a position's
    bits depend on its index alone), in bounded memory."""
    flat = p.reshape(-1)
    out = torch.empty(flat.shape, dtype=torch.bool, device=p.device)
    for lo in range(0, flat.numel(), SIGN_DRAW_RANGE):
        hi = min(lo + SIGN_DRAW_RANGE, flat.numel())
        counts = torch.arange(lo, hi, dtype=torch.int64, device=p.device)
        out[lo:hi] = prng.uniform_at(key, counts) < flat[lo:hi]
    return out.reshape(p.shape)


def _stochastic_sign_compress(g: torch.Tensor, key: torch.Tensor) -> torch.Tensor:
    """Paper Q_s: per-tensor stochastic sign with temperature K = mean |g|."""
    k_temp = g.abs().mean() + 1e-12
    q = torch.sigmoid(g / k_temp)
    bit = _bernoulli(key, q).to(g.dtype)
    return (2.0 * bit - 1.0) * k_temp


def make_train_step(model: T.Model, opt: optim.Optimizer, *, microbatches: int = 1,
                    kv_chunk: int = 1024, grad_compression: Optional[str] = None) -> Callable:
    """(params, opt_state, batch[, key]) -> (loss, params, opt_state).

    The batch's leading axis splits into ``microbatches`` equal parts; each
    part's gradients (``torch.autograd.grad``) are added, in order, onto
    float32 zeros, and the sums and the summed loss are divided by
    ``microbatches``, as the reference's ``lax.scan`` does.  The returned
    parameters are new tensors; the step does not write into its inputs.
    On ``meta`` parameters one microbatch is traced, counted
    ``microbatches`` times.
    """
    if grad_compression not in (None, "stochastic_sign"):
        raise ValueError(f"grad_compression={grad_compression!r}: None or 'stochastic_sign'")
    loss_fn = make_loss_fn(model, kv_chunk=kv_chunk)

    def step(params, opt_state, batch, key=None):
        params = tree_map(lambda p: p.detach().requires_grad_(), params)
        leaves = tree_leaves(params)
        dev = leaves[0].device
        mbatch = {k: v.reshape((microbatches, v.shape[0] // microbatches) + v.shape[1:])
                  for k, v in batch.items()}
        loss_sum = torch.zeros((), dtype=torch.float32, device=dev)
        grads = [torch.zeros(p.shape, dtype=torch.float32, device=p.device) for p in leaves]
        traced = 1 if dev.type == "meta" else microbatches
        with cost.repeat(microbatches // traced):
            for i in range(traced):
                with spans.span("train.fwd_bwd", dev):
                    loss = loss_fn(params, {k: v[i] for k, v in mbatch.items()})
                    mb_grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                                   materialize_grads=True)
                    loss_sum = loss_sum + loss.detach()
                    for acc, g in zip(grads, mb_grads):
                        acc.add_(g)
                    del loss, mb_grads
        loss = loss_sum / microbatches
        for g in grads:
            g.div_(microbatches)

        if grad_compression == "stochastic_sign":
            with spans.span("train.sign", dev):
                keys = prng.split(key, len(leaves))
                grads = [_stochastic_sign_compress(g, keys[i]) for i, g in enumerate(grads)]

        with torch.no_grad(), spans.span("train.update", dev):
            params, opt_state = opt.update(tree_unflatten(params, grads), params,
                                           opt_state)
        return loss, params, opt_state

    return step


def batch_tensors(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """A numpy batch (``data.batches_for``) as tensors on ``device``: the
    integer arrays (tokens, labels, positions) as int64, as indexing and
    ``gather`` take them; the float arrays as they are."""
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if not t.is_floating_point():
            t = t.to(torch.int64)
        out[k] = t.to(device)
    return out


# ---------------------------------------------------------------------------
# Setup without allocation, and the trainer
# ---------------------------------------------------------------------------


class TrainSetup(NamedTuple):
    model: T.Model
    opt_name: str
    opt: optim.Optimizer
    param_specs: Any
    opt_specs: Any
    params_sds: Any         # the stacked parameters, on ``meta``
    opt_sds: Any            # ``opt.init(params_sds)``, on ``meta``
    step_fn: Callable


def build_setup(cfg: ArchConfig, *, lr: float = 1e-4, microbatches: int = 1,
                kv_chunk: int = 1024, fsdp: bool = True,
                grad_compression: Optional[str] = None) -> TrainSetup:
    """Everything needed to trace a train step, allocating nothing: the
    specs are the active mesh's (``sharding.set_mesh``)."""
    model = T.build(cfg)
    opt_name, opt = choose_optimizer(cfg, lr)
    params_sds, param_specs = T.abstract_init(model)
    if fsdp:
        param_specs = T.fsdp_specs(params_sds, param_specs)
    opt_sds = opt.init(params_sds)
    o_specs = opt_state_specs(opt_name, params_sds, param_specs)
    step_fn = make_train_step(model, opt, microbatches=microbatches, kv_chunk=kv_chunk,
                              grad_compression=grad_compression)
    return TrainSetup(model, opt_name, opt, param_specs, o_specs, params_sds, opt_sds,
                      step_fn)


def shardings_for(mesh: Mesh, specs):
    """Each spec of the tree on ``mesh`` (``sharding.Sharding``)."""
    return tree_map(lambda sp: sharding.Sharding(mesh, sp), specs, is_leaf=is_spec)


class Trainer:
    """Parameters, optimizer state and key schedule on one device.

    ``params`` is a stacked tree (``convert.stacked_params`` carries the
    reference's ``init_params`` across); without it the port's own
    ``transformer.init_params`` draws the weights from ``seed``.  The key
    schedule is the reference's: ``fold_in(PRNGKey(seed), 1)``, then one
    ``split`` per step.
    """

    def __init__(self, cfg: ArchConfig, mesh: Optional[Mesh] = None, *, lr: float = 1e-4,
                 microbatches: int = 1, kv_chunk: int = 1024,
                 grad_compression: Optional[str] = None, seed: int = 0, params=None,
                 device="cuda"):
        if mesh is not None and mesh.size > 1:
            raise ValueError(f"the port trains on one device; mesh {mesh.shape} has "
                             f"{mesh.size}")
        self.mesh = mesh
        sharding.set_mesh(mesh)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = T.build(cfg)
        self.opt_name, self.opt = choose_optimizer(cfg, lr)
        self.step_fn = make_train_step(self.model, self.opt, microbatches=microbatches,
                                       kv_chunk=kv_chunk, grad_compression=grad_compression)
        key = prng.PRNGKey(seed, self.device)
        if params is None:
            params = convert.stack_model_params(
                self.model, T.init_params(self.model, seed, self.device))
        self.params = params
        self.opt_state = self.opt.init(self.params)
        self.key = prng.fold_in(key, 1)

    def step(self, batch: Dict[str, np.ndarray]) -> float:
        """One step on a batch of numpy arrays (``data.batches_for``); the
        mean loss."""
        with spans.span("train.step", self.device):
            ks = prng.split(self.key)
            self.key, k = ks[0], ks[1]
            loss, self.params, self.opt_state = self.step_fn(
                self.params, self.opt_state, batch_tensors(batch, self.device), k)
            with spans.span("train.sync", self.device):
                return float(loss)


# ---------------------------------------------------------------------------
# CLI launcher:
#   PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b --reduced \
#       --steps 50 [--batch 4 --seq 128 --bicompfl --ckpt run.ckpt --device cpu]
# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    import argparse
    import time

    import repro_torch.configs as configs
    from repro_torch import checkpoint
    from repro_torch.data import batches_for
    from repro_torch.launch.mesh import make_host_mesh

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b", choices=list(configs.ALIASES))
    ap.add_argument("--reduced", action="store_true",
                    help="train the reduced (CPU-sized) variant")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--bicompfl", action="store_true",
                    help="BiCompFL stochastic-sign gradient compression")
    ap.add_argument("--ckpt", default=None,
                    help="save the parameters (the reference's tree) here at the end")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = configs.get(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    print(f"training {cfg.name}: {cfg.params_count()/1e6:.1f}M params")

    trainer = Trainer(cfg, mesh=make_host_mesh(), lr=args.lr,
                      microbatches=args.microbatches, kv_chunk=args.seq,
                      grad_compression="stochastic_sign" if args.bicompfl else None,
                      device=args.device)
    t0 = time.time()
    losses = []
    for step_i, batch in enumerate(batches_for(cfg, args.batch, args.seq, n=args.steps)):
        losses.append(trainer.step(batch))
        if step_i % args.log_every == 0 or step_i == args.steps - 1:
            tok_s = (step_i + 1) * args.batch * args.seq / (time.time() - t0)
            print(f"step {step_i:5d}  loss {losses[-1]:8.4f}  "
                  f"({tok_s:,.0f} tok/s)", flush=True)
    if args.ckpt:
        checkpoint.save(args.ckpt, trainer.params, step=args.steps)
        print(f"saved {args.ckpt}")
    return 0 if (len(losses) < 2 or losses[-1] < losses[0]) else 1


if __name__ == "__main__":
    import sys
    sys.exit(main())
