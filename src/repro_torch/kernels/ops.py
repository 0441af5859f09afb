"""Routing wrappers around the port's kernels (port of ``repro.kernels.ops``).

Each wrapper takes the plain PyTorch version for a tensor on the CPU and the
hand-written CUDA kernel for a tensor on the card; it never falls back from
one to the other.  A tensor on the ``meta`` device also takes the plain
version's route: only shapes flow and nothing runs (the dry run traces the
model so, ``launch/dryrun.py``).  Any other device raises.  The two model kernels'
wrappers are differentiable (``torch.autograd.Function``): the kernel or
plain version runs forward, and the backward differentiates a recomputed
plain version, as the reference trains through its jnp routes and through
no Pallas kernel.  Each has a ``launches``
count that goes up by one where it launches its kernel and nowhere else, so
a run can show that its main path went through the kernel.  Where it
launches its kernel it also reports the launch's work (``kernels.cost``)
to the active cost modes (``launch.op_cost``), which see no ``ctypes``
call; each route runs inside ``cost.region`` of the wrapper's name.  The
card route is the span ``kernel.<wrapper's name>`` (``repro_torch.spans``):
the kernel's checks, its ``ctypes`` call and its launcher.
"""
from __future__ import annotations

import torch

from repro_torch import prng, spans
from . import bernoulli_kl as _kl
from . import cost
from . import flash_attn as _fa
from . import mrc_weights as _mw
from . import rwkv_chunk as _rw
from . import segment_logw as _seg
from . import threefry_draw as _tf


def _route(fn, plain, kernel, t: torch.Tensor, *args, work=None):
    """``plain(*args)`` for ``t`` on the CPU or ``meta``, ``kernel(*args)``
    on the card; ``work()`` (default: ``cost.<name>(*args)``) is the
    launch's work, reported when a cost mode is active."""
    name = fn.__name__
    with cost.region(name):
        if t.device.type in ("cpu", "meta"):
            return plain(*args)
        if t.device.type != "cuda":
            raise ValueError(f"{name} runs on cpu, meta or cuda, not {t.device}")
        with spans.span(fn.span_name, t.device):
            out = kernel(*args)
        fn.launches += 1
        if cost.active():
            cost.report(name, work() if work is not None else getattr(cost, name)(*args))
    return out


def mrc_logw(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """logW = X @ a + sum(b); x (NB, NIS, S), a/b (NB, S) -> (NB, NIS).

    Drop-in ``logw_fn`` for ``repro_torch.core.mrc.encode_fixed``.  NIS and
    S may be ragged: the kernel needs no padding.  The codec's default
    route is ``mrc_fixed_encode``, which draws the candidates in the kernel.
    """
    return _route(mrc_logw, _mw.mrc_logw_ref, _mw.mrc_logw_cuda, x, x, a, b)


def mrc_fixed_encode(shared_key: torch.Tensor, select_key: torch.Tensor,
                     pc: torch.Tensor, a: torch.Tensor, b: torch.Tensor, n_is: int):
    """The fixed-block codec's whole encoder; shared_key (2,) or (C, 2),
    select_key (C, 2) (or (2,) with (B, S) coefficients), pc/a/b (C, B, S)
    -> (indices (C, B) int64, sample (C, B, S), logw (C, B, n_is)).

    Candidate row i of block j of client c is ``uniform(fold_in(key, j),
    (n_is, S))[i]``, key the one shared key or client c's own (the PR
    variants' private candidates).  On the card one kernel launch draws the
    candidates in place, weighs them, adds the Gumbel noise of
    ``select_key``, takes the argmax and writes the chosen rows: the
    candidates never reach memory.  ``core.mrc.encode_fixed`` calls it when
    no ``logw_fn`` is given.
    """
    return _route(mrc_fixed_encode, _mw.mrc_fixed_encode_ref, _mw.mrc_fixed_encode_cuda, pc,
                  shared_key, select_key, pc, a, b, n_is)


def bernoulli_kl(q: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Per-block KL(q||p) sums; q, p (NB, S) -> (NB,) nats.  S may be ragged."""
    return _route(bernoulli_kl, _kl.rows_ref, _kl.rows_cuda, q, q, p)


def bernoulli_kl_total(q: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Mean-over-clients total KL(q||p): q, p (n, d) -> 0-d tensor (nats).

    The statistic ``AdaptiveAvgAllocation`` reads (as ``total / d``).
    """
    return _route(bernoulli_kl_total, _kl.total_ref, _kl.total_cuda, q, q, p)


def bernoulli_kl_profile(q: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Per-parameter cohort-mean KL(q||p): q, p (n, d) -> (d,) nats.

    The statistic ``AdaptiveAllocation`` reads.  The kernel sums each
    parameter's clients down a column: no transpose, no padding.
    """
    return _route(bernoulli_kl_profile, _kl.profile_ref, _kl.profile_cuda, q, q, p)


def segment_logw(u: torch.Tensor, p: torch.Tensor, a: torch.Tensor,
                 b: torch.Tensor, seg_ids: torch.Tensor, n_seg: int) -> torch.Tensor:
    """Segment MRC log-weights; u (NIS, D), p/a/b (D,) or (C, D), seg_ids
    (D,) non-decreasing from 0 (int32 on the card) -> (..., NIS, n_seg).

    Drop-in ``seg_logw_fn`` for ``repro_torch.core.mrc.encode_segments``.
    ``u`` is shared by the clients: one launch serves the cohort.  The
    codec's default route is ``segment_mrc_encode``, which draws u in the
    kernel.
    """
    return _route(segment_logw, _seg.segment_logw_ref, _seg.segment_logw_cuda, u,
                  u, p, a, b, seg_ids, n_seg)


def segment_mrc_encode(shared_key: torch.Tensor, select_key: torch.Tensor,
                       pc: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                       seg_ids: torch.Tensor, n_is: int, n_seg: int):
    """The segment codec's whole encoder; shared_key (2,) or (C, 2),
    select_key (C, 2) (or (2,) with (D,) coefficients), pc/a/b (C, D),
    seg_ids (D,) non-decreasing from 0 (int32 on the card) -> (indices
    (C, n_seg) int64, sample (C, D), logw (C, n_is, n_seg)).

    Candidate row i of client c is ``uniform(fold_in(key, i), (D,))``, key
    the one shared key or client c's own (the PR variants' private
    candidates).  On the card the kernel draws it in place (three device
    launches, one count): the (n_is, D) uniforms never reach memory.  ``core.mrc.encode_segments``
    calls it when no ``seg_logw_fn`` is given.
    """
    return _route(segment_mrc_encode, _seg.segment_mrc_encode_ref,
                  _seg.segment_mrc_encode_cuda, pc, shared_key, select_key, pc, a, b,
                  seg_ids, n_is, n_seg)


def segment_select(shared_key: torch.Tensor, indices: torch.Tensor, pc: torch.Tensor,
                   seg_ids: torch.Tensor) -> torch.Tensor:
    """The segment decoder: the chosen candidate rows re-thresholded,
    shared_key (2,) or (N..., 2), indices (N..., n_seg) int64 (int32 too on
    the CPU), pc (N..., D) -> (N..., D); only the chosen rows' elements are
    drawn.  The card runs the
    select pass of ``segment_mrc_encode``'s kernel."""
    return _route(segment_select, _seg.segment_select_ref, _seg.segment_select_cuda, pc,
                  shared_key, indices, pc, seg_ids)


def threefry_draw(key: torch.Tensor, at, ndim: int = 0, out: str = "bits",
                  p: torch.Tensor = None) -> torch.Tensor:
    """One Threefry-2x32 draw of ``prng``: key (K..., 2) int64 words; ``at``
    a shape, an int or a tensor of positions (last ``ndim`` axes the
    sample); ``out`` "words", "bits", "unit" or "bernoulli" (against ``p``,
    ``at`` then ``p.shape[key.dim() - 1:]``).  ``prng.draw_int64`` says
    what each computes; it is the plain version.

    Every draw of ``prng`` comes here.  On the card it is one launch
    (``csrc/threefry_draw.cu``) in native uint32, in place of ~180 int64
    elementwise ops, and safe to capture in a CUDA graph; an empty draw is
    counted but launches nothing.
    """
    return _route(threefry_draw, prng.draw_int64, _tf.threefry_draw_cuda, key,
                  key, at, ndim, out, p)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0, scale: float = 1.0,
                    kv_chunk: int = _fa.KV_CHUNK) -> torch.Tensor:
    """Causal or sliding-window softmax attention; q (B, Sq, H, Dh), k/v
    (B, Skv, Hkv, Dh) with H a multiple of Hkv -> (B, Sq, H, Dh) in q's type.

    The kernel reads the model's layout: no kv-head repeat, no head fold,
    no padding.  f32 or bf16; Dh a multiple of 8 up to 128.  On the card
    the type alone picks the kernel: bf16 runs the wgmma + TMA kernel, f32
    the split-TF32 wgmma kernel (both: 16-byte-aligned pointers and strides,
    else ``ValueError``).  The CPU route scans KV in chunks of
    ``min(kv_chunk, Skv)``, as the reference model's ``attention`` does.

    Differentiable: the forward is the route above, on detached inputs; the
    backward recomputes the plain chunked scan (``chunk_attn_scan``, the
    reference's training route) and differentiates it.  Under ``no_grad``
    it is the forward alone.
    """
    return _FlashAttention.apply(q, k, v, causal, window, scale, kv_chunk)


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale, kv_chunk):
        ctx.save_for_backward(q, k, v)
        ctx.opts = dict(causal=causal, window=window, scale=scale)
        ctx.kv_chunk = kv_chunk

        def plain(q, k, v):
            return _fa.flash_attention_ref(q, k, v, kv_chunk=kv_chunk, **ctx.opts)

        def kernel(q, k, v):
            return _fa.flash_attention_cuda(q, k, v, **ctx.opts)

        q, k, v = q.detach(), k.detach(), v.detach()
        return _route(flash_attention, plain, kernel, q, q, k, v,
                      work=lambda: cost.flash_attention(q, k, v, causal, window))

    @staticmethod
    def backward(ctx, grad):
        def scan(q, k, v):
            return _fa.chunk_attn_scan(q, k, v, q_offset=0,
                                       kv_chunk=min(ctx.kv_chunk, k.shape[1]), **ctx.opts)

        with cost.region("flash_attention"):
            return _plain_grads(ctx, scan, grad) + (None,) * 4


def rwkv_time_mix(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  logw: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Chunked RWKV-6 time-mix from a zero state; r/k/v/logw (B, S, H, 64),
    u (H, 64) -> (B, S, H, 64) in r's type.  The final state is not returned.

    On the card one call launches the kernel's two passes (intra-chunk
    terms, then the state carry) and counts one launch.  Differentiable as
    ``flash_attention`` is: the backward recomputes the plain chunked form
    (``time_mix_chunked``, chunks of 64) and differentiates it.
    """
    return _RWKVTimeMix.apply(r, k, v, logw, u)


class _RWKVTimeMix(torch.autograd.Function):
    @staticmethod
    def forward(ctx, r, k, v, logw, u):
        ctx.save_for_backward(r, k, v, logw, u)
        args = [t.detach() for t in (r, k, v, logw, u)]
        return _route(rwkv_time_mix, _rw.rwkv_time_mix_ref, _rw.rwkv_time_mix_cuda,
                      args[0], *args)

    @staticmethod
    def backward(ctx, grad):
        with cost.region("rwkv_time_mix"):
            return _plain_grads(ctx, _rw.rwkv_time_mix_ref, grad)


def _plain_grads(ctx, plain, grad) -> tuple:
    """Gradients of ``plain`` at the saved inputs (None where none is needed):
    the plain version recomputed with grad enabled."""
    saved = ctx.saved_tensors
    needs = ctx.needs_input_grad[:len(saved)]
    with torch.enable_grad():
        inputs = [t.detach().requires_grad_(n) for t, n in zip(saved, needs)]
        out = plain(*inputs)
        wanted = [t for t in inputs if t.requires_grad]
        grads = iter(torch.autograd.grad(out, wanted, grad))
    return tuple(next(grads) if n else None for n in needs)


for _fn in (mrc_logw, mrc_fixed_encode, bernoulli_kl, bernoulli_kl_total,
            bernoulli_kl_profile, segment_logw, segment_mrc_encode, segment_select,
            threefry_draw, flash_attention, rwkv_time_mix):
    _fn.launches = 0
    _fn.span_name = f"kernel.{_fn.__name__}"


def mrc_logw_fn():
    """The ``logw_fn`` hook for ``encode_fixed`` (the u-fed kernel route);
    its launches are counted on ``mrc_logw.launches``."""
    return mrc_logw


def segment_logw_fn():
    """The ``seg_logw_fn`` hook for ``encode_segments`` (the kernel route);
    its launches are counted on ``segment_logw.launches``."""
    return segment_logw
