"""Minimal Random Coding with shared randomness (port of ``repro.core.mrc``).

Encoder and decoder hold a common prior P (Bernoulli parameters) and a shared
threefry key.  Both derive the same ``n_is`` candidates X_1..X_{n_is} ~ P;
the encoder, which also holds the posterior Q, samples an index I with
probability proportional to Q(X_i)/P(X_i) (Gumbel-max) and transmits only I,
log2(n_is) bits per block.

Two codecs, as in the reference: fixed-size blocks, and variable-size
segments for the adaptive allocation.  Candidates of block ``j``, row ``i``
are the uniforms ``uniform(fold_in(key, j), (n_is, S))[i]``, and candidate
row ``i`` of the segment codec is ``uniform(fold_in(key, i), (d,))``,
exactly as in the reference, so both packages draw the same candidates;
the decoders regenerate only the selected rows.

Batching replaces ``vmap``: ``q`` and ``p`` are ``(N..., B, S)`` with any
leading batch axes (the cohort), and a key is either one key ``(2,)``
shared by the whole batch (the GR variant's common candidates) or one key
per batch element ``(N..., 2)`` (the PR variants' private candidates), in
both codecs.  By default each codec's whole batch is one call of its
fused encoder (``kernels.ops.mrc_fixed_encode``, ``kernels.ops
.segment_mrc_encode``: one kernel on the card, which draws the candidates
in place).  Given a hook, the importance weights of the whole batch go
through ONE ``logw_fn`` call of shape ``(prod(N)*B, n_is, S)`` (one
``seg_logw_fn`` call for the segment codec, one per element under
per-element keys); the indices do not depend on how the blocks are
batched.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from repro_torch import prng
from repro_torch.kernels import ops
from repro_torch.kernels.mrc_weights import block_keys, mrc_fixed_encode_ref, mrc_logw_ref
from repro_torch.kernels.segment_logw import segment_logw_ref, segment_mrc_encode_ref

from .bernoulli import clip01, log_ratio_coeffs

# ---------------------------------------------------------------------------
# Key derivation (the paper's shared randomness).
# ---------------------------------------------------------------------------


def round_key(base: torch.Tensor, t) -> torch.Tensor:
    """Shared key for global round t."""
    return prng.fold_in(base, t)


def client_key(base: torch.Tensor, client_id) -> torch.Tensor:
    """Private shared randomness between the federator and one client."""
    return prng.fold_in(prng.fold_in(base, 0x5EED), client_id)


def sample_key(base: torch.Tensor, ell) -> torch.Tensor:
    """Per conveyed-sample (ell in [n_UL] or [n_DL]) candidate key."""
    return prng.fold_in(base, ell)


def _selected_candidate(shared_key: torch.Tensor, rows: torch.Tensor,
                        size: int) -> torch.Tensor:
    """The selected uniform row of every block: rows ``(N..., B)`` -> ``(N..., B, size)``."""
    keys = block_keys(shared_key, rows.shape[-1])
    cols = torch.arange(size, dtype=torch.int64, device=rows.device)
    return prng.uniform_at(keys, rows.to(torch.int64)[..., None] * size + cols)


# ---------------------------------------------------------------------------
# Fixed-size block codec.
# ---------------------------------------------------------------------------

LogWFn = Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]
# signature: (X: (nb, n_is, S) {0,1}, a: (nb, S), b: (nb, S)) -> (nb, n_is)

# Plain importance log-weights, logW = X @ a + sum(b), the reference's jnp
# default.  Without a ``logw_fn``, ``encode_fixed`` runs the whole encoder
# through ``kernels.ops.mrc_fixed_encode``.
default_logw = mrc_logw_ref


class MRCResult(NamedTuple):
    indices: torch.Tensor  # (N..., B) int64 -- what goes over the wire
    sample: torch.Tensor   # (N..., B, S) {0,1} -- decoder-side reconstruction


def sample_mean(x: torch.Tensor) -> torch.Tensor:
    """Mean over axis 0, rounded as the reference rounds ``jnp.mean``.

    XLA turns the division by the count into a multiply by its float32
    reciprocal, so a mean of {0,1} samples is ``sum * f32(1/n)`` there (for
    n = 10, 9/10 becomes 0.90000004, not 0.9), and it sums the rows one
    after the other; ``torch.sum`` over axis 0 does not always (a few
    columns of a real-valued (5, 1001) sum differ).  Doing both as XLA does
    keeps the port's model bit-identical to the reference's, for the
    {0,1} samples of BiCompFL and the real-valued deltas of CFL and the
    baselines alike.
    """
    total = x[0]
    for row in x[1:]:
        total = total + row
    return total * torch.full((), 1.0 / x.shape[0], dtype=x.dtype, device=x.device)


def encode_fixed(shared_key: torch.Tensor, select_key: torch.Tensor,
                 q: torch.Tensor, p: torch.Tensor, *, n_is: int,
                 logw_fn: Optional[LogWFn] = None) -> MRCResult:
    """MRC-encode posterior q against prior p, both ``(N..., B, S)``.

    Returns the transmitted indices and the sample the decoder will see
    (identical to what ``decode_fixed`` reconstructs from the indices).
    Without ``logw_fn`` the whole encoder is ``kernels.ops
    .mrc_fixed_encode``: on the card one kernel that draws the candidates in
    place, on the CPU the plain version.  A ``logw_fn`` (e.g.
    ``kernels.ops.mrc_logw_fn()``) takes the unfused route, with every
    block's candidates drawn into an ``(N..., B, n_is, S)`` tensor and
    weighed by it in one call.
    """
    a, b = log_ratio_coeffs(q, p)                                  # (N..., B, S)
    n_blocks, s = a.shape[-2:]
    lead = torch.broadcast_shapes(a.shape[:-2], select_key.shape[:-1],
                                  shared_key.shape[:-1])

    def flat(t, tail):  # (N..., *tail) -> (C, *tail), what the kernel takes
        return t.expand(lead + tail).reshape((-1,) + tail).contiguous()

    key = shared_key if shared_key.dim() == 1 else flat(shared_key, (2,))
    args = (key, flat(select_key, (2,)), flat(clip01(p), (n_blocks, s)),
            flat(a, (n_blocks, s)), flat(b, (n_blocks, s)), n_is)
    if logw_fn is None:
        idx, sample, _ = ops.mrc_fixed_encode(*args)
    else:
        idx, sample, _ = mrc_fixed_encode_ref(*args, logw_fn=logw_fn)
    return MRCResult(indices=idx.reshape(lead + (n_blocks,)),
                     sample=sample.reshape(lead + (n_blocks, s)))


def decode_fixed(shared_key: torch.Tensor, indices: torch.Tensor,
                 p: torch.Tensor, *, n_is: int) -> torch.Tensor:
    """Reconstruct the encoder-selected sample from the indices: ``(N..., B, S)``.

    Regenerates only the selected candidate row of each block (O(d), not
    O(d * n_is)); ``n_is`` is kept for the reference's signature.
    """
    u = _selected_candidate(shared_key, indices, p.shape[-1])
    return (u < clip01(p)).to(torch.float32)


def transmit_fixed(shared_key: torch.Tensor, select_key: torch.Tensor,
                   q: torch.Tensor, p: torch.Tensor, *, n_is: int,
                   n_samples: int = 1, logw_fn: Optional[LogWFn] = None):
    """Convey ``n_samples`` i.i.d. MRC samples of q (fresh candidates per ell).

    Returns ``(indices (N..., n_samples, B), mean_sample (N..., B, S))``;
    the mean sample is the decoder-side estimate of q.
    """
    idxs, samples = [], []
    for ell in range(n_samples):
        res = encode_fixed(sample_key(shared_key, ell), sample_key(select_key, ell),
                           q, p, n_is=n_is, logw_fn=logw_fn)
        idxs.append(res.indices)
        samples.append(res.sample)
    return torch.stack(idxs, dim=-2), sample_mean(torch.stack(samples))


def receive_fixed(shared_key: torch.Tensor, indices: torch.Tensor,
                  p: torch.Tensor, *, n_is: int) -> torch.Tensor:
    """Decode relayed index vectors ``(N..., n_samples, B)`` -> ``(N..., B, S)``."""
    samples = [decode_fixed(sample_key(shared_key, ell), indices[..., ell, :], p,
                            n_is=n_is)
               for ell in range(indices.shape[-2])]
    return sample_mean(torch.stack(samples))


# ---------------------------------------------------------------------------
# Variable-size (segment) codec for the adaptive block allocation.
# ---------------------------------------------------------------------------


SegLogWFn = Callable[[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
                      torch.Tensor, int], torch.Tensor]
# signature: (u: (n_is, d) uniforms shared by the clients, p: (C, d) clipped prior,
#             a: (C, d), b: (C, d), seg_ids: (d,), n_seg) -> (C, n_is, n_seg);
# under per-client keys it is called once per client, with (d,) coefficients.

# Plain segment log-weights, the reference's jnp default (``where`` and a
# segment sum).  Without a ``seg_logw_fn``, ``encode_segments`` runs the
# whole encoder through ``kernels.ops.segment_mrc_encode``.
default_segment_logw = segment_logw_ref


def _validate_seg_ids(seg_ids) -> np.ndarray:
    """Host-side check of the segment-codec contract; returns the ids.

    The wire block-plan header encodes a segmentation as run-lengths, so a
    permuted ``seg_ids`` would round-trip the header to a *different*
    segmentation and decode a wrong sample with no error.  Enforce
    non-decreasing ids starting at 0 (the kernel also reads each segment as
    one contiguous run).
    """
    seg = seg_ids.cpu().numpy() if isinstance(seg_ids, torch.Tensor) \
        else np.asarray(seg_ids)
    if seg.ndim != 1 or seg.size == 0:
        raise ValueError(
            f"seg_ids must be a non-empty 1-D vector, got shape {seg.shape}")
    if int(seg[0]) != 0 or np.any(np.diff(seg) < 0):
        raise ValueError(
            "seg_ids must be non-decreasing and start at 0: the wire plan "
            "header stores segments as run-lengths, so any other ordering "
            "round-trips to a different segmentation")
    return seg


def _seg_tensor(seg_ids, device) -> torch.Tensor:
    """The ids as an int32 tensor on ``device`` (what the kernel takes).

    Host plans (numpy) are validated on the host.  An int32 tensor already
    on ``device`` is the fused path's plan (``finalize_plan``), built by a
    cumulative sum and so non-decreasing by construction; it passes
    unchecked, as the reference passes traced ids, because a captured round
    cannot copy it to the host.  Its segment 0 may be empty (ids starting
    at 1) and its last segments too; the codec sums an empty segment to 0.
    """
    if isinstance(seg_ids, torch.Tensor) and seg_ids.dtype == torch.int32 \
            and seg_ids.device == torch.device(device):
        return seg_ids
    return torch.as_tensor(_validate_seg_ids(seg_ids).astype(np.int32), device=device)


def _encode_segments(shared_key, select_key, q, p, seg, *, n_is, n_seg,
                     seg_logw_fn) -> MRCResult:
    a, b = log_ratio_coeffs(q, p)                                  # (N..., d)
    d = a.shape[-1]
    lead = torch.broadcast_shapes(a.shape[:-1], select_key.shape[:-1],
                                  shared_key.shape[:-1])

    def flat(t, width):  # (N..., width) -> (C, width), what the kernel takes
        return t.expand(lead + (width,)).reshape(-1, width).contiguous()

    key = shared_key if shared_key.dim() == 1 else flat(shared_key, 2)
    args = (key, flat(select_key, 2), flat(clip01(p), d), flat(a, d), flat(b, d),
            seg, n_is, n_seg)
    if seg_logw_fn is None:
        idx, sample, _ = ops.segment_mrc_encode(*args)
    else:
        idx, sample, _ = segment_mrc_encode_ref(*args, seg_logw_fn=seg_logw_fn)
    return MRCResult(indices=idx.reshape(lead + (n_seg,)), sample=sample.reshape(lead + (d,)))


def encode_segments(shared_key: torch.Tensor, select_key: torch.Tensor,
                    q: torch.Tensor, p: torch.Tensor, seg_ids, *, n_is: int,
                    n_seg: int, seg_logw_fn: Optional[SegLogWFn] = None) -> MRCResult:
    """MRC over variable blocks given per-parameter segment ids ``(d,)``.

    ``q`` and ``p`` are ``(N..., d)``; ``shared_key`` is one key ``(2,)``
    (common candidates: one ``(n_is, d)`` draw serves the whole batch) or
    one key per element ``(N..., 2)`` (the PR variants' private candidates:
    one draw per element); ``select_key`` is ``(N..., 2)``.  Returns
    indices ``(N..., n_seg)`` and the decoder-side sample ``(N..., d)``.

    logW(i, s) = sum_{e in s} x_ie a_e + sum_{e in s} b_e, with the
    candidate term a fused compare+select ``where(u < p, a, 0)``; the
    selected sample is re-thresholded from the chosen candidate row only.
    Without ``seg_logw_fn`` the whole encoder is ``kernels.ops
    .segment_mrc_encode``: on the card one kernel that draws the candidates
    in place, on the CPU the plain version.  A ``seg_logw_fn`` (e.g.
    ``kernels.ops.segment_logw_fn()``) takes the unfused route, with the
    candidates drawn into an ``(n_is, d)`` tensor and weighed by it.
    """
    seg = _seg_tensor(seg_ids, q.device)
    return _encode_segments(shared_key, select_key, q, p, seg, n_is=n_is,
                            n_seg=n_seg, seg_logw_fn=seg_logw_fn)


def _decode_segments(shared_key, indices, p, seg) -> torch.Tensor:
    pc = clip01(p)
    lead = torch.broadcast_shapes(indices.shape[:-1], pc.shape[:-1], shared_key.shape[:-1])
    idx = indices.to(torch.int64).expand(lead + indices.shape[-1:]).contiguous()
    key = shared_key if shared_key.dim() == 1 else \
        shared_key.expand(lead + (2,)).contiguous()
    return ops.segment_select(key, idx, pc.expand(lead + pc.shape[-1:]).contiguous(), seg)


def decode_segments(shared_key: torch.Tensor, indices: torch.Tensor,
                    p: torch.Tensor, seg_ids, *, n_is: int) -> torch.Tensor:
    """Reconstruct the encoder-selected sample from segment indices: ``(N..., d)``.

    Regenerates only the selected candidate row of each parameter (O(d),
    not O(d * n_is)), through ``kernels.ops.segment_select`` (the encoder
    kernel's select pass on the card); ``shared_key`` is ``(2,)`` or one
    key per element ``(N..., 2)``, as in ``encode_segments``; ``n_is`` is
    kept for the reference's signature.
    """
    return _decode_segments(shared_key, indices, p, _seg_tensor(seg_ids, p.device))


def transmit_segments(shared_key: torch.Tensor, select_key: torch.Tensor,
                      q: torch.Tensor, p: torch.Tensor, seg_ids, *, n_is: int,
                      n_seg: int, n_samples: int = 1,
                      seg_logw_fn: Optional[SegLogWFn] = None):
    """Convey ``n_samples`` i.i.d. segment-MRC samples of q.

    Returns ``(indices (N..., n_samples, n_seg), mean_sample (N..., d))``.
    """
    seg = _seg_tensor(seg_ids, q.device)
    idxs, samples = [], []
    for ell in range(n_samples):
        res = _encode_segments(sample_key(shared_key, ell), sample_key(select_key, ell),
                               q, p, seg, n_is=n_is, n_seg=n_seg,
                               seg_logw_fn=seg_logw_fn)
        idxs.append(res.indices)
        samples.append(res.sample)
    return torch.stack(idxs, dim=-2), sample_mean(torch.stack(samples))


def receive_segments(shared_key: torch.Tensor, indices: torch.Tensor,
                     p: torch.Tensor, seg_ids, *, n_is: int) -> torch.Tensor:
    """Decode relayed segment-index vectors ``(N..., n_samples, n_seg)`` -> ``(N..., d)``."""
    seg = _seg_tensor(seg_ids, p.device)
    samples = [_decode_segments(sample_key(shared_key, ell), indices[..., ell, :], p, seg)
               for ell in range(indices.shape[-2])]
    return sample_mean(torch.stack(samples))
