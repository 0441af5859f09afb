"""The kernels' work, and the hooks through which a cost mode counts it.

One place for the arithmetic and the bytes each hand-written kernel does:
``chip_smoke.py`` reckons every kernel's bound from these formulas, and
``kernels.ops`` reports a launch's ``Work`` to the active cost modes
(``launch.op_cost``), which see no kernel otherwise: the kernels are called
through ``ctypes``, below torch's dispatcher.

Bytes count each input read once and each output written once; ``flops``
counts a multiply-add as 2.  ``draws`` counts the threefry draws of the
keyed encoders, whose bound is their SASS instructions at the issue rate
(``chip_smoke.py`` reads the instructions per draw from a probe).

The hooks: ``report`` hands a launch's work to every active mode;
``region(name)`` names what a mode counts inside it (the ``ops`` wrappers
name their kernel, on either route); ``repeat(n)`` scales what is counted
inside it by ``n``, as the reference's HLO cost model multiplies a loop
body by its trip count; ``repeated(fn, n, ...)`` is ``fn`` once with its
forward and its backward each counted ``n`` times.
"""
from __future__ import annotations

import contextlib
import math
from typing import List, NamedTuple

import numpy as np
import torch

from repro_torch.prng import DRAW_DTYPES, draw_dims


class Work(NamedTuple):
    flops: float
    nbytes: float
    draws: float = 0.0


# ---------------------------------------------------------------------------
# Formulas, one per ``ops`` wrapper, on the wrapper's arguments.
# ---------------------------------------------------------------------------


def mrc_logw(x, a, b) -> Work:
    nb, nis, _ = x.shape
    return Work(2 * x.numel() + b.numel(), 4 * (x.numel() + a.numel() + b.numel() + nb * nis))


def mrc_fixed_encode(shared_key, select_key, pc, a, b, n_is) -> Work:
    """Candidates drawn once for the cohort under a shared key, once per
    client under client keys, plus one Gumbel draw per candidate and client;
    bytes of p, a, b, the sample, logW, the indices and the keys."""
    c, nb, s = pc.shape
    draws = (c if shared_key.dim() == 2 else 1) * nb * n_is * s + c * nb * n_is
    nbytes = 4 * (4 * c * nb * s + c * nb * n_is) \
        + 8 * (c * nb + shared_key.numel() + select_key.numel())
    return Work(2 * c * nb * n_is * s + c * nb * s, nbytes, draws)


def _kl(q, nbytes_out: int) -> Work:
    return Work(14 * q.numel(), 4 * 2 * q.numel() + 4 * nbytes_out)


def bernoulli_kl(q, p) -> Work:
    return _kl(q, q.shape[0])


def bernoulli_kl_total(q, p) -> Work:
    return _kl(q, 1)


def bernoulli_kl_profile(q, p) -> Work:
    return _kl(q, q.shape[-1])


def segment_logw(u, p, a, b, seg_ids, n_seg) -> Work:
    nis, d = u.shape
    c = p.shape[0] if p.dim() == 2 else 1
    return Work(2 * c * nis * d, 4 * (u.numel() + 3 * c * d + d + c * nis * n_seg))


def segment_mrc_encode(shared_key, select_key, pc, a, b, seg_ids, n_is, n_seg) -> Work:
    """As ``mrc_fixed_encode``, over segments: bytes of p, a, b, the seg
    ids, the sample, logW, the indices and the keys."""
    n, d = pc.shape if pc.dim() == 2 else (1, pc.shape[0])
    draws = (n if shared_key.dim() == 2 else 1) * n_is * d + n * n_is * n_seg
    nbytes = 4 * (3 * n * d + d + n * d + n * n_is * n_seg) \
        + 8 * (n * n_seg + shared_key.numel() + select_key.numel())
    return Work(2 * n * n_is * d, nbytes, draws)


def segment_select(shared_key, indices, pc, seg_ids) -> Work:
    """Only the chosen rows' elements are drawn: one draw and one compare a
    parameter; bytes of p, the seg ids, the result, the indices, the keys."""
    d = pc.shape[-1]
    return Work(pc.numel(), 4 * (2 * pc.numel() + d) + 8 * (indices.numel() + shared_key.numel()),
                pc.numel())


def threefry_draw(key, at, ndim, out, p=None) -> Work:
    """One draw a position; bytes of the key, the explicit positions or
    ``p`` as given, and the output."""
    lead, sample = draw_dims(key, at, ndim, out, p)
    n = math.prod(lead) * math.prod(sample)
    nbytes = 8 * key.numel() + n * (2 if out == "words" else 1) * DRAW_DTYPES[out].itemsize
    if out == "bernoulli":
        nbytes += p.numel() * p.element_size()
    elif isinstance(at, torch.Tensor):
        nbytes += 8 * at.numel()
    return Work(0.0, nbytes, n)


def visible_pairs(sq: int, skv: int, causal: bool, window: int) -> int:
    """(query, key) pairs the mask leaves: the attention's data-dependent work."""
    i = np.arange(sq)
    hi = np.minimum(i + 1, skv) if causal else np.full(sq, skv)
    lo = np.maximum(i - window + 1, 0) if window > 0 else np.zeros(sq, np.int64)
    return int(np.maximum(hi - lo, 0).sum())


def flash_attention(q, k, v, causal: bool, window: int) -> Work:
    """QK^T and PV over the visible pairs only; q, k, v read and the output
    written once."""
    b, sq, h, dh = q.shape
    flops = 4 * b * h * dh * visible_pairs(sq, k.shape[1], causal, window)
    return Work(flops, q.element_size() * (2 * q.numel() + k.numel() + v.numel()))


def rwkv_flops(b, s, h, dh=64) -> int:
    """The fewest f32 operations of the mix (an FMA is 2, an exp 1): the
    per-token recurrence, per token and head, reads r.S (Dh Dh FMAs), updates
    S = w*S + k(x)v (a product and an FMA each of Dh Dh), takes Dh exps for
    w and adds the bonus (r*u*k).v (3 Dh + 2 Dh)."""
    return b * s * h * (5 * dh * dh + 6 * dh)


def rwkv_time_mix(r, k, v, logw, u) -> Work:
    b, s, h, dh = r.shape
    return Work(rwkv_flops(b, s, h, dh), r.element_size() * 5 * r.numel() + 4 * u.numel())


# ---------------------------------------------------------------------------
# Hooks for the cost modes.
# ---------------------------------------------------------------------------

_SINKS: List = []          # the active modes (``launch.op_cost.OpCost``)
_SCALE = [1.0]             # the product of the enclosing ``repeat`` counts
_REGION: List[str] = []    # the enclosing ``region`` names, innermost last


def active() -> bool:
    return bool(_SINKS)


def scale() -> float:
    return _SCALE[-1]


def current_region() -> str:
    return _REGION[-1] if _REGION else ""


def report(name: str, work: Work) -> None:
    """A kernel launch's work, to every active mode."""
    for sink in _SINKS:
        sink.add_kernel(name, work)


@contextlib.contextmanager
def repeat(n: int):
    """What the active modes count inside is counted ``n`` times."""
    _SCALE.append(_SCALE[-1] * n)
    try:
        yield
    finally:
        _SCALE.pop()


@contextlib.contextmanager
def region(name: str):
    _REGION.append(name)
    try:
        yield
    finally:
        _REGION.pop()


def _keep(t):
    return t


class _Repeated(torch.autograd.Function):
    """``fn`` run once under ``repeat(n)``; its backward runs under
    ``repeat(n)`` too (the graph of the one run, differentiated).  Every
    float input is differentiated, as in a middle step, where the carried
    state depends on the parameters (the first step's does not)."""

    @staticmethod
    def forward(ctx, fn, n, *inputs):
        ctx.n = n
        # The one run's graph keeps its own tensors: under a non-reentrant
        # checkpoint, the checkpoint's hooks would otherwise rerun the whole
        # checkpointed forward inside ``backward``, under ``repeat(n)``.
        with torch.enable_grad(), torch.autograd.graph.saved_tensors_hooks(_keep, _keep):
            ins = [t.detach().requires_grad_(t.is_floating_point())
                   if isinstance(t, torch.Tensor) else t for t in inputs]
            with repeat(n):
                outs = fn(*ins)
        ctx.ins, ctx.outs = ins, outs
        return tuple(o.detach() for o in outs)

    @staticmethod
    def backward(ctx, *grads):
        wanted = [t for t in ctx.ins if isinstance(t, torch.Tensor) and t.requires_grad]
        pairs = [(o, g) for o, g in zip(ctx.outs, grads) if o.requires_grad and g is not None]
        with repeat(ctx.n):
            got = iter(torch.autograd.grad([o for o, _ in pairs], wanted,
                                           [g for _, g in pairs], allow_unused=True)
                       if pairs and wanted else [None] * len(wanted))
        out = [next(got) if isinstance(t, torch.Tensor) and t.requires_grad else None
               for t in ctx.ins]
        return (None, None, *(g if need else None
                              for g, need in zip(out, ctx.needs_input_grad[2:])))


def repeated(fn, n: int, *inputs):
    """``fn(*inputs)`` (a tuple of tensors) once, counted as ``n`` runs,
    forward and, under autograd, backward.  For a loop of ``n`` steps of
    equal shapes traced on the ``meta`` device, where only the count
    matters: the outputs are the one step's."""
    if n == 1:
        return fn(*inputs)
    if torch.is_grad_enabled() and any(isinstance(t, torch.Tensor) and t.requires_grad
                                       for t in inputs):
        return _Repeated.apply(fn, n, *inputs)
    with repeat(n):
        return fn(*inputs)
