"""Chunked RWKV-6 time-mix: the hand-written CUDA kernel and its plain versions.

Port of ``repro.kernels.rwkv_chunk.rwkv_chunk_pallas`` (the TPU kernel).
The CUDA source is ``csrc/rwkv_chunk.cu``; its header gives the bound and
the design.  Shapes: ``r``, ``k``, ``v``, ``logw`` are ``(B, S, H, 64)``
(``logw <= 0`` is the log of the decay), ``u`` is ``(H, 64)``; the result
is ``(B, S, H, 64)``.  The mix starts from a zero state, and the kernel
does not return the final state.

Plain versions, ports of the reference model's two forms of the same
recurrence (``repro.models.rwkv6``):

* ``time_mix_sequential``: the per-token recurrence, with any initial state;
* ``time_mix_chunked``: the chunked closed form.

``rwkv_time_mix_ref`` is the chunked form with ``C = 64`` from a zero state:
the CPU route of ``kernels.ops.rwkv_time_mix`` and the oracle the kernel is
held against on the card.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import build, cost

NAME = "rwkv_chunk"
CHUNK = 64
HEAD = 64
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def time_mix_sequential(rf, kf, vf, logw, u, s0):
    """Per-token recurrence.  rf/kf/vf/logw: (B, S, H, Dh) f32; u: (H, Dh);
    s0: (B, H, Dh, Dh).  Returns (out (B, S, H, Dh) f32, final state)."""
    w = torch.exp(logw)
    s = s0
    outs = []
    for t in range(rf.shape[1]):
        kv = torch.einsum("bhk,bhv->bhkv", kf[:, t], vf[:, t])
        outs.append(torch.einsum("bhk,bhkv->bhv", rf[:, t], s + u[None, :, :, None] * kv))
        s = w[:, t, ..., None] * s + kv
    return torch.stack(outs, dim=1), s


def time_mix_chunked(rf, kf, vf, logw, u, s0, *, chunk: int):
    """Chunked closed form of the same recurrence (f32 math per chunk).

    Within a chunk, with c_t = cumsum(logw) (<= 0):

      o_t   = (r_t . e^{c_{t-1}}) S_in + sum_{s<t} (r_t k_s e^{c_{t-1}-c_s}) v_s
              + (r_t . u . k_t) v_t
      S_out = e^{c_C} . S_in + sum_s (k_s e^{c_C - c_s}) v_s^T

    Returns (out in ``rf``'s type, final state).
    """
    b, s, h, dh = rf.shape
    out_dtype = rf.dtype
    n_chunks = -(-s // chunk)
    pad = n_chunks * chunk - s
    if pad:
        z = lambda t: torch.nn.functional.pad(t, (0, 0, 0, 0, 0, pad))  # noqa: E731
        rf, kf, vf, logw = z(rf), z(kf), z(vf), z(logw)
    tri = torch.tril(torch.ones(chunk, chunk, dtype=torch.float32, device=rf.device), -1)

    def step(r, k, v, lw, u, s_in):
        r, k, v, lw = (t.to(torch.float32) for t in (r, k, v, lw))
        cum = torch.cumsum(lw, dim=1)                             # c_t (inclusive)
        cum_prev = cum - lw                                       # c_{t-1}
        o_inter = torch.einsum("bthk,bhkv->bthv", r * torch.exp(cum_prev), s_in)
        diff = cum_prev[:, :, None] - cum[:, None, :]             # (B, t, s, H, Dh)
        dmat = torch.exp(torch.clamp(diff, max=0.0))
        p = torch.einsum("bthk,bshk,btshk->bths", r, k, dmat)
        p = p * tri[None, :, None, :]
        o_intra = torch.einsum("bths,bshv->bthv", p, v)
        o_diag = torch.einsum("bthk,hk,bthk->bth", r, u, k)[..., None] * v
        decay_to_end = torch.exp(cum[:, -1:] - cum)               # c_C - c_s
        a_end = torch.exp(cum[:, -1])                             # (B, H, Dh)
        s_out = a_end[..., None] * s_in + torch.einsum("bshk,bshv->bhkv",
                                                       k * decay_to_end, v)
        return (o_inter + o_intra + o_diag).to(out_dtype), s_out

    if rf.device.type == "meta":
        # only shapes flow: one chunk traced, counted n_chunks times
        o, s_in = cost.repeated(step, n_chunks, *(t[:, :chunk] for t in (rf, kf, vf, logw)),
                                u, s0)
        return torch.cat([o] * n_chunks, dim=1)[:, :s], s_in
    s_in = s0
    outs = []
    for c in range(n_chunks):
        sl = slice(c * chunk, (c + 1) * chunk)
        o, s_in = step(rf[:, sl], kf[:, sl], vf[:, sl], logw[:, sl], u, s_in)
        outs.append(o)
    return torch.cat(outs, dim=1)[:, :s], s_in


def rwkv_time_mix_ref(r, k, v, logw, u) -> torch.Tensor:
    """Plain version of the kernel (zero initial state, C = 64), in ``r``'s type."""
    b, _, h, dh = r.shape
    s0 = torch.zeros((b, h, dh, dh), dtype=torch.float32, device=r.device)
    out, _ = time_mix_chunked(r.to(torch.float32), k.to(torch.float32),
                              v.to(torch.float32), logw.to(torch.float32),
                              u.to(torch.float32), s0, chunk=CHUNK)
    return out.to(r.dtype)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = build.library(NAME)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.rwkv_chunk_launch.argtypes = [vp, vp, vp, vp, vp, vp, vp, ci, ci, ci,
                                      ctypes.POINTER(ctypes.c_int64), ci, vp]
    lib.rwkv_chunk_launch.restype = ci
    return lib


def rwkv_time_mix_cuda(r, k, v, logw, u) -> torch.Tensor:
    """Launch the CUDA kernel's two passes on the current stream (intra-chunk
    terms into an f32 scratch of the output's shape, then the state carry);
    raises on bad input."""
    if r.dim() != 4 or any(t.shape != r.shape for t in (k, v, logw)):
        raise ValueError(f"{NAME}: r, k, v, logw must share one (B, S, H, Dh) shape; got "
                         f"{[tuple(t.shape) for t in (r, k, v, logw)]}")
    b, s, h, dh = r.shape
    if dh != HEAD:
        raise ValueError(f"{NAME}: head size {dh} unsupported (RWKV-6 heads are {HEAD})")
    if tuple(u.shape) != (h, dh):
        raise ValueError(f"{NAME}: u {tuple(u.shape)} must be (H, Dh) = {(h, dh)}")
    build.check_strided_inputs(NAME, {"r": r, "k": k, "v": v, "logw": logw}, DTYPES)
    build.check_strided_inputs(NAME, {"u": u}, {torch.float32})
    if u.device != r.device or not u.is_contiguous():
        raise ValueError(f"{NAME}: u must be contiguous on {r.device}")
    if s > build.INT32_MAX - CHUNK or b * h > build.INT32_MAX or b > 65535 or h > 65535:
        raise ValueError(f"{NAME}: sizes {tuple(r.shape)} out of range")
    out = torch.empty((b, s, h, dh), dtype=r.dtype, device=r.device)
    scratch = torch.empty((b, s, h, dh), dtype=torch.float32, device=r.device)
    strides = (ctypes.c_int64 * 12)(*(t.stride(i) for t in (r, k, v, logw)
                                      for i in range(3)))
    lib = _library()
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        rc = lib.rwkv_chunk_launch(r.data_ptr(), k.data_ptr(), v.data_ptr(),
                                   logw.data_ptr(), u.data_ptr(), scratch.data_ptr(),
                                   out.data_ptr(), b, s, h,
                                   strides, DTYPES[r.dtype], stream)
    build.check(NAME, lib, rc)
    return out
