"""Flash attention: the hand-written CUDA kernel and its plain version.

Port of ``repro.kernels.flash_attn.flash_attention_pallas`` (the TPU
kernel).  The CUDA source is ``csrc/flash_attn.cu``; its header gives the
bound and the design.  Shapes: ``q`` is ``(B, Sq, H, Dh)``, ``k`` and ``v``
are ``(B, Skv, Hkv, Dh)`` with ``H`` a multiple of ``Hkv`` (GQA); the
result is ``(B, Sq, H, Dh)`` in ``q``'s type.  Query position ``i`` sees
key ``j`` when ``j <= i`` (causal) and ``j > i - window`` (``window > 0``).

``chunk_attn_scan`` is the plain version: the port of the reference model's
``layers._chunk_attn_scan``, the function the reference computes where the
kernel was meant to drop in.  ``flash_attention_ref`` is it as the kernel's
counterpart (query offset 0, kv chunks of ``min(1024, Skv)``, the
reference model's ``attention`` default): the CPU route of
``kernels.ops.flash_attention`` and the oracle the kernel is held against
on the card.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import build, cost

NAME = "flash_attn"
# Negative-infinity substitute that is safe in bf16 softmax arithmetic
# (the reference's ``layers.NEG_INF``).
NEG_INF = -1e9
KV_CHUNK = 1024
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def chunk_attn_scan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool,
                    window: int, q_offset: int, kv_chunk: int, scale: float) -> torch.Tensor:
    """Lazy-softmax attention, scanning KV in chunks (plain PyTorch).

    ``q_offset`` is the absolute position of ``q[:, 0]``.  Every product and
    the running (max, denominator, accumulator) are f32, as in the reference.
    """
    b, sq, h, dh = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    rep = h // hkv
    n_chunks = -(-skv // kv_chunk)
    q32 = q.to(torch.float32) * scale
    qpos = q_offset + torch.arange(sq, device=q.device)
    m = torch.full((b, h, sq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, h, sq, dh), dtype=torch.float32, device=q.device)

    def step(lo, q32, k, v, m, l, acc):
        hi = min(lo + kv_chunk, skv)
        kc = k[:, lo:hi].to(torch.float32).repeat_interleave(rep, dim=2)
        vc = v[:, lo:hi].to(torch.float32).repeat_interleave(rep, dim=2)
        if hi - lo < kv_chunk:                   # the reference's zero padding
            pad = (0, 0, 0, 0, 0, kv_chunk - (hi - lo))
            kc, vc = torch.nn.functional.pad(kc, pad), torch.nn.functional.pad(vc, pad)
        s = torch.einsum("bqhd,bkhd->bhqk", q32, kc)
        kpos = lo + torch.arange(kv_chunk, device=q.device)
        mask = (kpos[None, :] < skv).expand(sq, kv_chunk)
        if causal:
            mask = mask & (kpos[None, :] <= qpos[:, None])
        if window > 0:
            mask = mask & (kpos[None, :] > qpos[:, None] - window)
        s = torch.where(mask[None, None], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum("bhqk,bkhd->bhqd", p, vc)
        return m_new, l, acc

    starts = list(range(0, skv, kv_chunk))
    if q.device.type == "meta" and len(starts) > 1:
        # only shapes flow: the full chunks' step traced once, counted as
        # many times (the masks differ in values only)
        full = skv // kv_chunk
        m, l, acc = cost.repeated(functools.partial(step, 0), full, q32, k, v, m, l, acc)
        starts = starts[full:]
    for lo in starts:
        m, l, acc = step(lo, q32, k, v, m, l, acc)
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 2, 1, 3).to(q.dtype)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int = 0, scale: float = 1.0,
                        kv_chunk: int = KV_CHUNK) -> torch.Tensor:
    """Plain version of the kernel; shapes as in the module docstring.  KV
    is scanned in chunks of ``min(kv_chunk, Skv)`` (the reference model's
    ``attention``; training passes the train step's ``kv_chunk``)."""
    return chunk_attn_scan(q, k, v, causal=causal, window=window, q_offset=0,
                           kv_chunk=min(kv_chunk, k.shape[1]), scale=scale)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = build.library(NAME)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.flash_attn_launch.argtypes = [vp, vp, vp, vp, ci, ci, ci, ci, ci, ci,
                                      ctypes.POINTER(ctypes.c_int64), ci, ci, ci,
                                      ctypes.c_float, vp]
    lib.flash_attn_launch.restype = ci
    return lib


def _check_tma(tensors: dict) -> None:
    """The kernels' 16-byte rules (the bf16 kernel's TMA tensor maps, the f32
    kernel's 16-byte loads): each base pointer 16-byte aligned, each byte
    stride (batch, sequence, head) a multiple of 16.  A stride of an axis of
    size 1 is never used and is not checked."""
    for tname, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{NAME}: {tname} starts at an address that is not 16-byte "
                             "aligned, which the kernels' 16-byte loads need")
        bad = [i for i in range(3) if t.shape[i] > 1 and (t.stride(i) * t.element_size()) % 16]
        if bad:
            raise ValueError(f"{NAME}: {tname} has byte strides "
                             f"{[t.stride(i) * t.element_size() for i in bad]} that are not "
                             "multiples of 16, which the kernels' 16-byte loads need")


def _strides(t: torch.Tensor):
    """(batch, sequence, head) element strides, with an axis of size 1 given
    the packed stride (any value is legal there; TMA wants a multiple of 16
    bytes)."""
    out, packed = [], t.shape[3]
    for i in (2, 1, 0):
        out.append(t.stride(i) if t.shape[i] > 1 else packed)
        packed = out[-1] * t.shape[i]
    return out[::-1]


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         causal: bool = True, window: int = 0,
                         scale: float = 1.0) -> torch.Tensor:
    """Launch a CUDA kernel on the current stream; raises on bad input.

    The input type alone picks the kernel: bf16 runs the wgmma + TMA kernel,
    f32 the split-TF32 wgmma kernel.  Both take every shape this wrapper
    accepts; pointers and strides must meet the 16-byte rules
    (``_check_tma``), else ``ValueError``.  Neither falls back to the other.
    """
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"{NAME}: q {tuple(q.shape)} must be (B, Sq, H, Dh) and k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} one (B, Skv, Hkv, Dh)")
    b, sq, h, dh = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != dh or hkv == 0 or h % hkv:
        raise ValueError(f"{NAME}: q {tuple(q.shape)} and k {tuple(k.shape)} disagree "
                         "in batch or head size, or H is not a multiple of Hkv")
    if dh > 128 or dh % 8:
        raise ValueError(f"{NAME}: head size {dh} unsupported (a multiple of 8, <= 128)")
    build.check_strided_inputs(NAME, {"q": q, "k": k, "v": v}, DTYPES)
    _check_tma({"q": q, "k": k, "v": v})
    if max(sq, skv) > build.INT32_MAX - 128 or b > 65535 or h > 65535:
        raise ValueError(f"{NAME}: sizes {tuple(q.shape)}, {tuple(k.shape)} out of range")
    out = torch.empty((b, sq, h, dh), dtype=q.dtype, device=q.device)
    strides = (ctypes.c_int64 * 9)(*(st for t in (q, k, v) for st in _strides(t)))
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.flash_attn_launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                                   b, sq, skv, h, hkv, dh, strides, DTYPES[q.dtype],
                                   int(bool(causal)), int(window), float(scale), stream)
    build.check(NAME, lib, rc)
    return out
