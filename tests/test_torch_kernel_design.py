"""The Hopper kernels' designs, emulated in plain PyTorch on the CPU.

The CUDA kernels cannot run here, but the algebra of their designs can: each
emulation below does what its kernel does, in the kernel's order and with
the kernel's roundings, and is held to the plain version the kernel is held
to on the card (``flash_attention_ref``, ``rwkv_time_mix_ref``) at the same
tolerances as ``tests/test_torch_cuda.py``.

* ``flash_split_p``: the bf16 flash kernel (``csrc/flash_attn.cu``, tensor
  cores): 128 query rows per CTA as two groups of 64, 64-key tiles, wholly
  masked tiles skipped per group, S = Q K^T from bf16 operands in f32,
  softmax in log2 units, and O += P_hi V + P_lo V with P split into two
  bf16 parts (the row sum from the f32 P).
* ``flash_split_tf32``: the f32 flash kernel (``csrc/flash_attn.cu``,
  split-TF32 on the tensor cores): 64 query rows per CTA, 32-key tiles over
  the CTA's range [kstart, kend) (tiles outside it, wholly masked, are
  never loaded), masks only on edge tiles, Q scaled in f32 before its
  split (the reference's rounding), S = Q_hi K_hi^T + (Q_hi K_lo^T +
  Q_lo K_hi^T) and O_tile = P_hi V_hi + P_hi V_lo + P_lo V_hi with every
  operand split into TF32 hi and lo parts (``tf32``, the kernel's integer
  rounding), O = O c + O_tile.
* ``rwkv_two_pass``: the RWKV kernel (``csrc/rwkv_chunk.cu``): pass A writes
  each chunk's intra-chunk term and u bonus to an f32 scratch; pass B walks
  the chunks per group of G state columns, adding (r e^{c_{t-1}}) S and
  carrying S.

Inputs are made with numpy from a seed.  The kernels' own build helper is
tested here too: its library name covers the headers a source includes.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import build
from repro_torch.kernels import flash_attn as fa
from repro_torch.kernels import rwkv_chunk as rc

# As in tests/test_torch_cuda.py: f32 terms summed in another order, within
# 1e-5 x the terms' magnitude; a bf16 output adds one bf16 ulp.
F32_RTOL = 1e-5
BF16_ULPS = 1
LOG2E = 1.4426950408889634
NEG_INF = -1e9


def _bf16_ulp(x):
    return torch.finfo(torch.bfloat16).eps * x.abs().to(torch.float32)


def _bf16(x):
    return x.to(torch.bfloat16).to(torch.float32)


def tf32(x):
    """f32 -> TF32 (10 mantissa bits), to nearest with ties away from zero,
    as the kernel's ``round_tf32`` does it: (bits + 0x1000) & 0xFFFFE000 on
    the uint32 bit pattern, so the value is exactly what the tensor cores
    read."""
    bits = x.to(torch.float32).contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    r = (bits + 0x1000) & 0xFFFFE000
    return torch.where(r >= 2 ** 31, r - 2 ** 32, r).to(torch.int32).view(torch.float32)


def _split(x):
    hi = tf32(x)
    return hi, tf32(x - hi)


def flash_split_p(q, k, v, *, causal, window, scale, split=True):
    """The bf16 flash kernel's algorithm; ``split=False`` rounds P to one
    bf16 instead (what FA2, FA3 and SDPA do)."""
    b, sq, h, dh = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    rep = h // hkv
    kf = k.float().repeat_interleave(rep, dim=2)
    vf = v.float().repeat_interleave(rep, dim=2)
    out = torch.zeros(b, sq, h, dh)
    for q0 in range(0, sq, 128):
        kend = min(skv, q0 + 128) if causal else skv
        kstart = max(0, q0 - window + 1) // 64 * 64 if window > 0 else 0
        for wlo in (q0, q0 + 64):
            if wlo >= sq:
                continue
            whi = wlo + 63
            rows = torch.arange(wlo, min(wlo + 64, sq))
            qf = q[:, wlo:wlo + len(rows)].float()
            m = torch.full((b, h, len(rows)), NEG_INF)
            l = torch.zeros(b, h, len(rows))
            o = torch.zeros(b, h, len(rows), dh)
            for k0 in range(kstart, kend, 64):
                if (causal and k0 > whi) or (window > 0 and k0 + 63 <= wlo - window):
                    continue                              # wholly masked for this group
                keys = torch.arange(k0, k0 + 64)
                kt = torch.zeros(b, 64, h, dh)
                vt = torch.zeros(b, 64, h, dh)
                n = min(64, skv - k0)
                kt[:, :n], vt[:, :n] = kf[:, k0:k0 + n], vf[:, k0:k0 + n]   # TMA's zero fill
                s = torch.einsum("bqhd,bkhd->bhqk", qf, kt) * (scale * LOG2E)
                ok = (keys[None, :] < skv).expand(len(rows), 64)
                if causal:
                    ok = ok & (keys[None, :] <= rows[:, None])
                if window > 0:
                    ok = ok & (keys[None, :] > rows[:, None] - window)
                s = torch.where(ok, s, NEG_INF)
                mx = torch.maximum(m, s.amax(-1))
                corr = torch.exp2(m - mx)
                p = torch.exp2(s - mx[..., None])
                l = l * corr + p.sum(-1)
                if split:
                    p_hi = _bf16(p)
                    pv = (torch.einsum("bhqk,bkhd->bhqd", p_hi, vt)
                          + torch.einsum("bhqk,bkhd->bhqd", _bf16(p - p_hi), vt))
                else:
                    pv = torch.einsum("bhqk,bkhd->bhqd", _bf16(p), vt)
                o = o * corr[..., None] + pv
                m = mx
            out[:, wlo:wlo + len(rows)] = (o / torch.clamp(l, min=1e-30)[..., None]).permute(0, 2, 1, 3)
    return out.to(q.dtype)


def flash_split_tf32(q, k, v, *, causal, window, scale, split=True):
    """The f32 flash kernel's algorithm; ``split=False`` rounds each operand
    to one TF32 instead (single-pass TF32, what ``allow_tf32`` would do)."""
    b, sq, h, dh = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    rep = h // hkv
    rows_cta, keys_tile = 64, 32
    kf = k.repeat_interleave(rep, dim=2)
    vf = v.repeat_interleave(rep, dim=2)

    def parts(x):
        return _split(x) if split else (tf32(x), torch.zeros_like(x))

    out = torch.zeros(b, sq, h, dh)
    for q0 in range(0, sq, rows_cta):
        kend = min(skv, q0 + rows_cta) if causal else skv
        kstart = max(0, q0 - window + 1) // keys_tile * keys_tile if window > 0 else 0
        rows = torch.arange(q0, q0 + rows_cta)          # the CTA computes all 64 rows
        qt = torch.zeros(b, rows_cta, h, dh)
        qt[:, :min(rows_cta, sq - q0)] = q[:, q0:q0 + rows_cta] * scale   # the reference's q * scale
        q_hi, q_lo = parts(qt)
        m = torch.full((b, h, rows_cta), NEG_INF)
        l = torch.zeros(b, h, rows_cta)
        o = torch.zeros(b, h, rows_cta, dh)
        for k0 in range(kstart, kend, keys_tile):
            keys = torch.arange(k0, k0 + keys_tile)
            kt = torch.zeros(b, keys_tile, h, dh)
            vt = torch.zeros(b, keys_tile, h, dh)
            n = min(keys_tile, skv - k0)
            kt[:, :n], vt[:, :n] = kf[:, k0:k0 + n], vf[:, k0:k0 + n]   # zeros past Skv
            ok = (keys[None, :] < skv).expand(rows_cta, keys_tile)
            if causal:
                ok = ok & (keys[None, :] <= rows[:, None])
            if window > 0:
                ok = ok & (keys[None, :] > rows[:, None] - window)
            assert bool(ok.any()), "a tile inside the CTA's range is wholly masked"
            k_hi, k_lo = parts(kt)
            s_big = torch.einsum("bqhd,bkhd->bhqk", q_hi, k_hi)
            s_small = (torch.einsum("bqhd,bkhd->bhqk", q_hi, k_lo)
                       + torch.einsum("bqhd,bkhd->bhqk", q_lo, k_hi))
            s = (s_big + s_small) * LOG2E
            edge = (k0 + keys_tile > skv or (causal and k0 + keys_tile - 1 > q0)
                    or (window > 0 and k0 <= q0 + rows_cta - 1 - window))
            if edge:
                s = torch.where(ok, s, NEG_INF)
            else:
                assert bool(ok.all())
            mx = torch.maximum(m, s.amax(-1))
            corr = torch.exp2(m - mx)
            p = torch.exp2(s - mx[..., None])
            l = l * corr + p.sum(-1)
            p_hi, p_lo = parts(p)
            v_hi, v_lo = parts(vt)
            o_tile = (torch.einsum("bhqk,bkhd->bhqd", p_hi, v_hi)
                      + torch.einsum("bhqk,bkhd->bhqd", p_hi, v_lo)
                      + torch.einsum("bhqk,bkhd->bhqd", p_lo, v_hi))
            o = o * corr[..., None] + o_tile
            m = mx
        res = (o / torch.clamp(l, min=1e-30)[..., None]).permute(0, 2, 1, 3)
        out[:, q0:q0 + rows_cta] = res[:, :min(rows_cta, sq - q0)]
    return out


def _flash_inputs(b, sq, skv, h, hkv, dh, seed, dtype=torch.bfloat16, q_scale=1.0):
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal((b, n, heads, dh), dtype=np.float32))
               for n, heads in ((sq, h), (skv, hkv), (skv, hkv)))
    return (q * q_scale).to(dtype), k.to(dtype), v.to(dtype)


def _attn_err_over_tol(got, q, k, v, **kw):
    want = fa.flash_attention_ref(q, k, v, **kw)
    mag = fa.flash_attention_ref(q.float(), k.float(), v.float().abs(), **kw)
    tol = F32_RTOL * mag + 1e-6
    if got.dtype == torch.bfloat16:
        tol = tol + BF16_ULPS * _bf16_ulp(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    return float(((got.float() - want.float()).abs() / tol).max())


FLASH_CASES = [
    # (b, sq, skv, h, hkv, dh), causal, window
    ((1, 200, 200, 2, 1, 8), True, 0),
    ((1, 200, 200, 2, 2, 40), True, 0),
    ((2, 150, 150, 2, 1, 64), True, 0),
    ((1, 130, 130, 2, 1, 128), True, 0),
    ((1, 100, 300, 2, 1, 64), True, 0),        # Sq < Skv
    ((1, 300, 100, 2, 2, 32), True, 0),        # Sq > Skv
    ((1, 90, 250, 2, 1, 40), False, 0),
    ((1, 700, 700, 1, 1, 64), True, 256),      # window across tile edges
    ((1, 333, 333, 2, 1, 128), False, 100),
]


@pytest.mark.parametrize("shape,causal,window", FLASH_CASES)
def test_flash_split_p_design_matches_plain(shape, causal, window):
    q, k, v = _flash_inputs(*shape, seed=sum(shape) + window)
    kw = dict(causal=causal, window=window, scale=shape[-1] ** -0.5)
    assert _attn_err_over_tol(flash_split_p(q, k, v, **kw), q, k, v, **kw) <= 1.0


def test_flash_single_bf16_p_misses_the_bound():
    """Why the kernel splits P: one bf16 P errs by ~2^-9 |v| / sqrt(n) per
    output, past 1e-5 x sum p|v| where the output is near 0."""
    shape = (1, 256, 256, 2, 1, 64)
    q, k, v = _flash_inputs(*shape, seed=7)
    kw = dict(causal=True, window=0, scale=0.125)
    assert _attn_err_over_tol(flash_split_p(q, k, v, **kw, split=False), q, k, v, **kw) > 2.0
    assert _attn_err_over_tol(flash_split_p(q, k, v, **kw), q, k, v, **kw) <= 1.0


@pytest.mark.parametrize("shape,causal,window", FLASH_CASES)
def test_flash_split_tf32_design_matches_plain(shape, causal, window):
    q, k, v = _flash_inputs(*shape, seed=sum(shape) + window + 1, dtype=torch.float32)
    kw = dict(causal=causal, window=window, scale=shape[-1] ** -0.5)
    assert _attn_err_over_tol(flash_split_tf32(q, k, v, **kw), q, k, v, **kw) <= 1.0


def _attn_exact(q, k, v, *, causal, window, scale):
    """The attention in float64, one softmax over every key: the value the
    f32 versions approximate."""
    rep = q.shape[2] // k.shape[2]
    kd, vd = (t.double().repeat_interleave(rep, dim=2) for t in (k, v))
    s = torch.einsum("bqhd,bkhd->bhqk", q.double(), kd) * scale
    i, j = torch.arange(q.shape[1])[:, None], torch.arange(k.shape[1])[None, :]
    ok = torch.ones(q.shape[1], k.shape[1], dtype=torch.bool)
    if causal:
        ok = ok & (j <= i)
    if window > 0:
        ok = ok & (j > i - window)
    p = torch.softmax(s.masked_fill(~ok, -torch.inf), -1)
    return torch.einsum("bhqk,bkhd->bqhd", p, vd), float(s.abs().max())


def test_flash_split_tf32_holds_large_scores():
    """Scores of magnitude ~30 (q scaled by 5, Dh 8): a sharp softmax, held
    to the plain version at the bound."""
    q, k, v = _flash_inputs(2, 200, 200, 2, 1, 8, seed=11, dtype=torch.float32, q_scale=5.0)
    kw = dict(causal=True, window=0, scale=8 ** -0.5)
    assert _attn_exact(q, k, v, **kw)[1] > 25.0
    assert _attn_err_over_tol(flash_split_tf32(q, k, v, **kw), q, k, v, **kw) <= 1.0


def test_flash_split_tf32_as_exact_as_f32_at_large_scores():
    """Scores of magnitude ~30 with Dh 128 (q scaled by 6): each score sums
    128 products of size ~6 in f32, and the plain version's own error
    against float64 reaches 0.67-1.02 of the bound here (seeds 11-13), so
    two f32 summation orders can differ by more than it.  The split is held
    to float64 at the bound instead: no further from the exact value than
    f32 arithmetic is."""
    q, k, v = _flash_inputs(2, 200, 200, 2, 1, 128, seed=11, dtype=torch.float32, q_scale=6.0)
    kw = dict(causal=True, window=0, scale=128 ** -0.5)
    exact, smax = _attn_exact(q, k, v, **kw)
    assert smax > 25.0
    mag = fa.flash_attention_ref(q, k, v.abs(), **kw)
    tol = F32_RTOL * mag + 1e-6
    got = flash_split_tf32(q, k, v, **kw)
    assert float(((got.double() - exact).abs() / tol).max()) <= 1.0


def test_flash_single_tf32_misses_the_bound():
    """Why the kernel splits every operand: one TF32 pass (11 significant
    bits) errs by ~2^-11 of each score and weight, far past 1e-5 x sum
    p|v|."""
    shape = (1, 256, 256, 2, 1, 64)
    q, k, v = _flash_inputs(*shape, seed=7, dtype=torch.float32)
    kw = dict(causal=True, window=0, scale=0.125)
    assert _attn_err_over_tol(flash_split_tf32(q, k, v, **kw, split=False), q, k, v, **kw) > 2.0
    assert _attn_err_over_tol(flash_split_tf32(q, k, v, **kw), q, k, v, **kw) <= 1.0


def _tf32_exact(x: float) -> float:
    """TF32 rounding in exact arithmetic: to 11 significant bits, to nearest
    with ties away from zero (the binade's exponent from frexp); subnormals
    on the same 2^-136 grid as the smallest normals' last bit."""
    import math
    if x == 0.0 or not math.isfinite(x):
        return x
    _, e = math.frexp(abs(x))
    step = 2.0 ** (max(e, -125) - 11)
    r = math.floor(abs(x) / step + 0.5) * step
    return math.copysign(r, x) if r < 2.0 ** 128 else math.copysign(math.inf, x)


@pytest.mark.parametrize("bits,want", [
    (0x3F800000, 0x3F800000),      # 1.0
    (0x3F800FFF, 0x3F800000),      # just below a tie: down
    (0x3F801000, 0x3F802000),      # a tie: away from zero
    (0xBF801000, 0xBF802000),      # a negative tie: away from zero
    (0x3F803000, 0x3F804000),      # a tie from an odd last bit: away, not to even
    (0x3FFFF000, 0x40000000),      # rounds up into the next binade (2.0)
    (0x00001000, 0x00002000),      # a subnormal tie
    (0x00000FFF, 0x00000000),      # a subnormal to zero
    (0x807FF000, 0x80800000),      # the largest subnormal up to the smallest normal
    (0x7F7FF000, 0x7F800000),      # past TF32's largest finite: infinity
    (0x80000000, 0x80000000),      # -0.0
])
def test_tf32_rounding_bit_patterns(bits, want):
    x = torch.tensor([bits - (2 ** 32 if bits >= 2 ** 31 else 0)], dtype=torch.int32)
    got = tf32(x.view(torch.float32)).view(torch.int32).item() & 0xFFFFFFFF
    assert got == want, (hex(got), hex(want))
    assert tf32(x.view(torch.float32)).item() == _tf32_exact(x.view(torch.float32).item())


def test_tf32_rounding_matches_exact_arithmetic_and_split_is_tight():
    rng = np.random.default_rng(5)
    x = torch.from_numpy(np.concatenate([
        rng.standard_normal(2000).astype(np.float32) * np.float32(2.0) ** rng.integers(
            -30, 30, 2000).astype(np.float32),
        rng.uniform(0.0, 1.0, 2000).astype(np.float32)]))
    got = tf32(x)
    assert [float(g) for g in got] == [_tf32_exact(float(v)) for v in x]
    assert bool(((got.view(torch.int32) & 0x1FFF) == 0).all())
    hi, lo = _split(x)
    assert bool(((x - hi - lo).abs() <= 2.0 ** -22 * x.abs()).all())


def _scan(lw):
    """The kernels' column scan of a chunk: four segments of 16 rows summed
    in order, the segment offsets added in order, c_{t-1} = c_t - logw_t;
    and pass B's c_C, the four segment sums added in order."""
    seg = lw.shape[1] // 4
    part = []
    for q in range(4):
        acc = torch.zeros_like(lw[:, 0])
        for t in range(seg):
            acc = acc + lw[:, q * seg + t]
        part.append(acc)
    cs = torch.empty_like(lw)
    for q in range(4):
        c = torch.zeros_like(part[0])
        for p in range(q):
            c = c + part[p]
        for t in range(q * seg, (q + 1) * seg):
            c = c + lw[:, t]
            cs[:, t] = c
    total = torch.zeros_like(part[0])
    for p in range(4):
        total = total + part[p]
    return cs, cs - lw, total


def rwkv_two_pass(r, k, v, logw, u, *, cols):
    """The RWKV kernel's two passes; ``cols`` value columns per pass-B group."""
    b, s, h, dh = r.shape
    c = rc.CHUNK
    n = -(-s // c)
    pad = (0, 0, 0, 0, 0, n * c - s)
    rf, kf, vf, lf = (torch.nn.functional.pad(t.float(), pad) for t in (r, k, v, logw))
    tri = torch.tril(torch.ones(c, c), -1)
    scratch = torch.zeros(b, n * c, h, dh)
    for i in range(n):                                         # pass A, one chunk each
        sl = slice(i * c, (i + 1) * c)
        cs, cp, _ = _scan(lf[:, sl])
        x = torch.clamp(cp[:, :, None] - cs[:, None, :], max=0.0)
        p = torch.einsum("bthk,bshk,btshk->bths", rf[:, sl], kf[:, sl],
                         torch.exp2(x * LOG2E)) * tri[None, :, None, :]
        bonus = torch.einsum("bthk,hk,bthk->bth", rf[:, sl], u.float(), kf[:, sl])
        scratch[:, sl] = torch.einsum("bths,bshv->bthv", p, vf[:, sl]) + bonus[..., None] * vf[:, sl]
    out = torch.empty(b, n * c, h, dh)
    for c0 in range(0, dh, cols):                              # pass B, one group each
        g = slice(c0, c0 + cols)
        state = torch.zeros(b, h, dh, cols)
        for i in range(n):
            sl = slice(i * c, (i + 1) * c)
            cs, cp, total = _scan(lf[:, sl])
            rr = rf[:, sl] * torch.exp2(cp * LOG2E)
            kk = kf[:, sl] * torch.exp2((total[:, None] - cs) * LOG2E)
            out[:, sl, :, g] = scratch[:, sl, :, g] + torch.einsum("bthk,bhkv->bthv", rr, state)
            state = (torch.exp2(total * LOG2E)[..., None] * state
                     + torch.einsum("bshk,bshv->bhkv", kk, vf[:, sl, :, g]))
    return out[:, :s].to(r.dtype)


def _rwkv_inputs(b, s, h, seed, strong=False, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    r, k, v = (torch.from_numpy(rng.standard_normal((b, s, h, 64), dtype=np.float32))
               for _ in range(3))
    logw = -torch.exp(torch.from_numpy(rng.standard_normal((b, s, h, 64), dtype=np.float32))
                      - 2.0)
    if strong:
        logw = torch.full_like(logw, -15.0)
    u = 0.1 * torch.from_numpy(rng.standard_normal((h, 64), dtype=np.float32))
    return (*(t.to(dtype) for t in (r, k, v, logw)), u)


@pytest.mark.parametrize("b,s,h,cols,strong,dtype", [
    (2, 200, 2, 16, False, torch.float32),
    (1, 200, 3, 8, False, torch.float32),
    (2, 64, 1, 16, True, torch.float32),
    (1, 150, 2, 16, True, torch.float32),
    (1, 1, 2, 16, False, torch.float32),
    (2, 130, 2, 16, False, torch.bfloat16),
])
def test_rwkv_two_pass_design_matches_plain(b, s, h, cols, strong, dtype):
    r, k, v, logw, u = _rwkv_inputs(b, s, h, seed=s + h + cols, strong=strong, dtype=dtype)
    got = rwkv_two_pass(r, k, v, logw, u, cols=cols)
    want = rc.rwkv_time_mix_ref(r, k, v, logw, u)
    assert got.shape == want.shape and got.dtype == dtype
    tol = F32_RTOL * want.float().abs().max() + 1e-6
    if dtype == torch.bfloat16:
        tol = tol + BF16_ULPS * _bf16_ulp(want)
    err = (got.float() - want.float()).abs()
    assert bool((err <= tol).all()), float((err / tol).max())


def test_rwkv_two_pass_groups_agree():
    """Pass B's column groups are independent: G = 8 and G = 16 give the
    same output up to rounding."""
    r, k, v, logw, u = _rwkv_inputs(1, 180, 2, seed=3)
    a = rwkv_two_pass(r, k, v, logw, u, cols=8)
    b = rwkv_two_pass(r, k, v, logw, u, cols=16)
    assert torch.allclose(a, b, rtol=0, atol=1e-5 * float(b.abs().max()))


def test_library_path_covers_included_headers(tmp_path, monkeypatch):
    (tmp_path / "k.cu").write_text('#include "a.cuh"\n#include <cuda_runtime.h>\n')
    (tmp_path / "a.cuh").write_text('#pragma once\n#include "b.cuh"\n')
    (tmp_path / "b.cuh").write_text("// b\n")
    (tmp_path / "other.cuh").write_text("// not included\n")
    monkeypatch.setattr(build, "CSRC", tmp_path)
    assert [p.name for p in build.inputs("k")] == ["k.cu", "a.cuh", "b.cuh"]
    first = build.library_path("k")
    (tmp_path / "other.cuh").write_text("// edited\n")
    assert build.library_path("k") == first
    (tmp_path / "b.cuh").write_text("// b, edited\n")
    second = build.library_path("k")
    assert second != first and second.parent == first.parent
    (tmp_path / "k.cu").write_text('#include "a.cuh"\n// edited\n')
    assert build.library_path("k") not in (first, second)


@pytest.mark.parametrize("name", ["flash_attn", "rwkv_chunk", "segment_logw"])
def test_model_kernels_share_the_common_header(name):
    assert [p.name for p in build.inputs(name)] == [f"{name}.cu", "common.cuh"]
    assert build.library_path(name).name.startswith(f"lib{name}-")


def test_flash_tma_checks_and_strides():
    """The bf16 wrapper's TMA rules and the strides it hands the tensor maps
    (pure host code: run here on CPU tensors)."""
    flat = torch.zeros(1 + 64 * 4 * 32, dtype=torch.bfloat16)
    good = torch.zeros(1, 64, 4, 32, dtype=torch.bfloat16)
    fa._check_tma({"q": good})
    with pytest.raises(ValueError, match="aligned"):
        fa._check_tma({"q": flat[1:].view(1, 64, 4, 32)})
    wide = torch.zeros(2, 64, 4, 36, dtype=torch.bfloat16)[..., :32]
    with pytest.raises(ValueError, match="multiples of 16"):
        fa._check_tma({"k": wide})
    qkv = torch.zeros(2, 300, 16, 128, dtype=torch.bfloat16)
    fa._check_tma({"q": qkv[:, :, :8], "k": qkv[:, :, 8:12]})
    assert fa._strides(qkv[:, :, 8:12]) == [300 * 16 * 128, 16 * 128, 128]
    # an axis of size 1 gets the packed stride, whatever its own
    one = torch.zeros(1, 5, 1, 8, dtype=torch.bfloat16).as_strided((1, 5, 1, 8), (3, 8, 1, 1))
    assert fa._strides(one) == [40, 8, 8]
    fa._check_tma({"q": one})
