"""The fused segment encoder (``ops.segment_mrc_encode``) on the CPU.

Three things are held here, where no card is:

* ``segment_mrc_encode_ref`` -- the plain version, which is the CPU route
  and the oracle of the keyed kernel on the card -- against the JAX
  package's ``repro.core.mrc.encode_segments`` on the same keys, over
  seeded and degenerate segmentations (one segment, all singletons, a
  segment spanning many 512-wide tiles, empty segments at the tail);
* a numpy emulation of the kernel's decomposition (``csrc/segment_logw.cu``):
  16-parameter strips per lane, runs closed at segment boundaries, the
  warp-segmented scan joining runs across lanes, pieces cut at 512-wide
  tile edges, the warp-cooperative search of pass 2.  Every parameter must
  land in exactly one piece of its own segment, and the emulated sums must
  equal the plain version's;
* the kernel's threefry, written as the kernel writes it (uint32 words,
  counters (0, row) and (0, e)), against ``repro_torch.prng``.

The CUDA kernel itself runs only on the card (``test_torch_cuda.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.core import mrc as jm
from repro.core.bernoulli import clip01 as j_clip01
from repro.core.bernoulli import log_ratio_coeffs as j_coeffs
from repro_torch import convert, prng
from repro_torch.core import mrc as tm
from repro_torch.core.bernoulli import clip01, log_ratio_coeffs
from repro_torch.kernels import ops
from repro_torch.kernels import segment_logw as sl
from repro_torch.kernels.segment_logw import (segment_candidates, segment_logw_ref,
                                              segment_mrc_encode_ref, segment_select_ref)

# Gumbel-max near-ties: a mismatched index is allowed only where the
# reference's top-2 gap in logW + gumbel is below this (as in
# test_torch_adaptive.py).
NEAR_TIE = 1e-4
# Emulated kernel sums vs the plain version: f32 terms summed in another
# order, within 1e-5 of the sum of the terms' magnitudes.
SUM_RTOL, SUM_ATOL = 1e-5, 1e-6
TILE, STRIP, LANES = 512, 16, 32
ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def segmentation(kind: str, d: int, seed: int):
    """(seg_ids int32 (d,), n_seg) of one kind; ids non-decreasing from 0."""
    rng = np.random.default_rng(seed)
    if kind == "single":
        return np.zeros(d, np.int32), 1
    if kind == "singletons":
        return np.arange(d, dtype=np.int32), d
    if kind == "long":          # one segment across many 512-wide tiles
        lo, hi = d // 20, d - d // 20
        ids = np.zeros(d, np.int64)
        ids[lo:hi] = 1
        ids[hi:] = 2 + np.arange(d - hi) // 7
        ids[:lo] = 0
        return ids.astype(np.int32), int(ids[-1]) + 1
    if kind == "dropped":       # ids >= n_seg, which the weights drop
        ids, n_seg = segmentation("random", d, seed)
        return ids, max(1, n_seg // 2)
    if kind == "empty_tail":    # trailing ids past the last parameter's
        ids = np.sort(rng.integers(0, max(d // 9, 1), d))
        ids -= ids[0]
        return ids.astype(np.int32), int(ids[-1]) + 1 + 5
    n_cuts = int(rng.integers(0, d))
    cuts = np.sort(rng.choice(np.arange(1, d), size=min(n_cuts, d - 1), replace=False)) \
        if d > 1 and n_cuts else np.array([], dtype=np.int64)
    lengths = np.diff(np.concatenate([[0], cuts, [d]]))
    return np.repeat(np.arange(lengths.size), lengths).astype(np.int32), lengths.size


KINDS = ["random", "single", "singletons", "long", "empty_tail"]
EMULATED_KINDS = KINDS + ["dropped"]


def _qp(seed, shape):
    rng = np.random.default_rng(seed)
    q = rng.uniform(0.02, 0.98, shape).astype(np.float32)
    p = np.clip(q + 0.1 * rng.standard_normal(shape), 0, 1).astype(np.float32)
    return q, p


# ---------------------------------------------------------------------------
# The plain version against the reference.
# ---------------------------------------------------------------------------


def _reference(k, sks, q, p, seg, n_is, n_seg):
    """The reference's encoder per client (vmap over clients), its scores
    logW + gumbel and the top-2 gap per (client, segment)."""
    res = jax.vmap(lambda s_, q_, p_: jm.encode_segments(
        k, s_, q_, p_, jnp.asarray(seg), n_is=n_is, n_seg=n_seg))(
        sks, jnp.asarray(q), jnp.asarray(p))
    u = jm._segment_candidates(k, n_is, q.shape[1])

    def score(s_, q_, p_):
        a, b = j_coeffs(q_, p_)
        logw = jm.default_segment_logw(u, j_clip01(p_), a, b, jnp.asarray(seg), n_seg)
        gu = jax.random.uniform(s_, (n_is, n_seg))
        return logw - jnp.log(-jnp.log(jnp.clip(gu, 1e-12, 1.0 - 1e-12)))

    scores = np.sort(np.asarray(jax.vmap(score)(sks, jnp.asarray(q), jnp.asarray(p))), axis=1)
    gap = scores[:, -1] - scores[:, -2] if n_is > 1 else np.full(scores[:, 0].shape, np.inf)
    return np.asarray(res.indices), np.asarray(res.sample), gap


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("clients,n_is,d", [(4, 32, 2048), (3, 7, 1001), (1, 32, 600),
                                            (2, 1, 37)])
def test_segment_mrc_encode_ref_matches_reference(kind, clients, n_is, d):
    seed = d + n_is + clients
    q, p = _qp(seed, (clients, d))
    seg, n_seg = segmentation(kind, d, seed)
    k = jax.random.PRNGKey(seed)
    sks = jax.random.split(jax.random.fold_in(k, 3), clients)
    ji, js, gap = _reference(k, sks, q, p, seg, n_is, n_seg)
    tq, tp = torch.tensor(q), torch.tensor(p)
    a, b = log_ratio_coeffs(tq, tp)
    before = ops.segment_mrc_encode.launches
    for fn in (segment_mrc_encode_ref, ops.segment_mrc_encode):
        idx, sample, logw = fn(convert.key(k, "cpu"), convert.key(sks, "cpu"), clip01(tp),
                               a, b, torch.tensor(seg), n_is, n_seg)
        assert idx.dtype == torch.int64 and tuple(idx.shape) == (clients, n_seg)
        assert tuple(logw.shape) == (clients, n_is, n_seg)
        ti = idx.numpy()
        diff = ji != ti
        print(f"{kind} {clients}x{n_is}x{d}: near-tie index mismatches "
              f"{int(diff.sum())} of {diff.size}")
        assert (gap[diff] < NEAR_TIE).all(), (gap[diff], ji[diff], ti[diff])
        same = ~diff[:, seg]
        np.testing.assert_array_equal(sample.numpy()[same], js[same])
        # the select pass alone (the decoder) gives the encoder's sample
        np.testing.assert_array_equal(
            segment_select_ref(convert.key(k, "cpu"), idx, clip01(tp),
                               torch.tensor(seg)).numpy(), sample.numpy())
    assert ops.segment_mrc_encode.launches == before      # the CPU route counts nothing


def test_encode_segments_default_route_is_the_fused_encoder():
    """``mrc.encode_segments`` without a hook goes through
    ``ops.segment_mrc_encode``, with a hook through the u-fed route; both
    give the same indices and sample on the CPU."""
    q, p = _qp(21, (3, 700))
    seg, n_seg = segmentation("random", 700, 21)
    key = prng.PRNGKey(5, device="cpu")
    sels = prng.split(prng.PRNGKey(6, device="cpu"), 3)
    calls = []

    def hook(*args):
        calls.append(args[0].shape)
        return ops.segment_logw(*args)

    fused = tm.encode_segments(key, sels, torch.tensor(q), torch.tensor(p), seg, n_is=16,
                               n_seg=n_seg)
    hooked = tm.encode_segments(key, sels, torch.tensor(q), torch.tensor(p), seg, n_is=16,
                                n_seg=n_seg, seg_logw_fn=hook)
    assert calls == [(16, 700)]
    assert torch.equal(fused.indices, hooked.indices)
    assert torch.equal(fused.sample, hooked.sample)
    one = tm.encode_segments(key, sels[1], torch.tensor(q[1]), torch.tensor(p[1]), seg,
                             n_is=16, n_seg=n_seg)
    assert torch.equal(one.indices, fused.indices[1])
    assert torch.equal(one.sample, fused.sample[1])


# ---------------------------------------------------------------------------
# numpy emulation of the kernel's decomposition (csrc/segment_logw.cu).
# ---------------------------------------------------------------------------


def _shfl_up(x, off):
    """__shfl_up_sync over the 32 lanes: lane l gets x[l - off], lanes
    below ``off`` keep their own."""
    return np.concatenate([x[:off], x[:-off]]) if off else x


def _strips(seg, t0, length):
    """strip_of for the 32 lanes of one tile."""
    n = np.clip(length - STRIP * np.arange(LANES), 0, STRIP)
    f, g, nruns = np.full(LANES, -1), np.full(LANES, -1), np.zeros(LANES, int)
    ends = np.zeros((LANES, STRIP), bool)
    for lane in range(LANES):
        if n[lane]:
            ids = seg[t0 + STRIP * lane: t0 + STRIP * lane + n[lane]]
            f[lane], g[lane] = ids[0], ids[-1]
            ends[lane, :n[lane]] = np.r_[ids[1:] != ids[:-1], True]
            nruns[lane] = ends[lane].sum()
    g_left, f_right = _shfl_up(g, 1), np.r_[f[1:], f[-1]]
    from_left = (np.arange(LANES) > 0) & (f >= 0) & (g_left == f)
    to_right = (np.arange(LANES) < LANES - 1) & (g >= 0) & (f_right == g)
    start = ~(from_left & (nruns == 1))
    take = np.zeros((5, LANES), bool)
    for j in range(5):
        off = 1 << j
        up = _shfl_up(start, off)
        take[j] = (np.arange(LANES) >= off) & ~start
        start = np.where(take[j], up, start)
    return n, f, g, nruns, ends, from_left, to_right, take


def _emulate_tile(seg, t0, length, v, n_seg, write):
    """reduce_pieces of one warp over one tile row: v (32, 16, m) values
    (0 past the strips' ends); ``write(s, value)`` for each piece."""
    n, f, g, nruns, ends, from_left, to_right, take = _strips(seg, t0, length)
    m = v.shape[-1]
    head, tail = np.zeros((LANES, m)), np.zeros((LANES, m))
    for lane in range(LANES):
        bits = sum(1 << k for k in range(STRIP) if ends[lane, k])
        first_end = (bits & -bits).bit_length() - 1             # __ffs(ends) - 1
        before_last = bits & ~(1 << max(int(n[lane]) - 1, 0))
        last_start = before_last.bit_length()                   # 32 - __clz(...)
        for k in range(STRIP):                                  # one branch-free pass
            head[lane] += v[lane, k] if k <= first_end else 0.0
            tail[lane] += v[lane, k] if k >= last_start else 0.0
        if nruns[lane] > 2:                                     # the runs in between
            acc = np.zeros(m)
            for k in range(first_end + 1, last_start):
                acc = acc + v[lane, k]
                if ends[lane, k]:
                    if seg[t0 + STRIP * lane + k] < n_seg:
                        write(seg[t0 + STRIP * lane + k], acc)
                    acc = np.zeros(m)
    sc = tail.copy()
    for j in range(5):
        up = _shfl_up(sc, 1 << j)
        sc = np.where(take[j][:, None], up + sc, sc)
    carry = _shfl_up(sc, 1)
    for lane in range(LANES):
        if nruns[lane] > 1 and f[lane] < n_seg:
            write(f[lane], carry[lane] + head[lane] if from_left[lane] else head[lane])
        if nruns[lane] > 0 and not to_right[lane] and g[lane] < n_seg:
            write(g[lane], sc[lane])


def _warp_lower_bound(seg, s):
    lo, hi = 0, len(seg)
    while lo < hi:
        step = (hi - lo + 31) >> 5
        pos = lo + np.arange(LANES) * step
        ge = np.array([p >= hi or seg[p] >= s for p in pos])
        first = int(np.argmax(ge)) if ge.any() else LANES
        if first == 0:
            return lo
        lo, hi = lo + (first - 1) * step + 1, min(lo + first * step, hi)
    return lo


def emulate(seg, n_seg, vals):
    """Pass 1 and pass 2's piece sums over one row: vals (d, m) -> (n_seg, m),
    and how many times each piece slot was written."""
    d, m = vals.shape
    n_tiles = -(-d // TILE)
    part = np.zeros((n_seg + n_tiles, m))
    writes = np.zeros(n_seg + n_tiles, int)
    for tile in range(n_tiles):
        t0 = tile * TILE
        length = min(TILE, d - t0)
        v = np.zeros((TILE, m))
        v[:length] = vals[t0:t0 + length]

        def write(s, value, tile=tile):
            part[s + tile] = value
            writes[s + tile] += 1

        _emulate_tile(seg, t0, length, v.reshape(LANES, STRIP, m), n_seg, write)
    out = np.zeros((n_seg, m))
    for s in range(n_seg):
        lo, hi = _warp_lower_bound(seg, s), _warp_lower_bound(seg, s + 1)
        assert (lo, hi) == tuple(np.searchsorted(seg, [s, s + 1]))
        for k in range(lo // TILE, (hi - 1) // TILE + 1 if lo < hi else lo // TILE):
            out[s] += part[s + k]
    return out, writes


@pytest.mark.parametrize("kind", EMULATED_KINDS)
@pytest.mark.parametrize("d", [2048, 1537, 513, 40, 1])
def test_pieces_cover_every_parameter_once(kind, d):
    """One-hot values: the emulated segment sums are the indicator of each
    segment's parameters, so every parameter lands in exactly one piece of
    its own segment; every piece slot is written at most once."""
    seg, n_seg = segmentation(kind, d, d)
    out, writes = emulate(seg, n_seg, np.eye(d))
    want = np.zeros((n_seg, d))
    want[seg[seg < n_seg], np.arange(d)[seg < n_seg]] = 1.0
    np.testing.assert_array_equal(out, want)
    assert writes.max() <= 1
    # pieces: (segment, tile) pairs that hold a parameter, one slot each
    pieces = {(s, e // TILE) for e, s in enumerate(seg) if s < n_seg}
    assert writes.sum() == len(pieces) and len({s + k for s, k in pieces}) == len(pieces)


@settings(deadline=None, max_examples=25)
@given(st.integers(1, 1600), st.integers(0, 2 ** 31 - 1), st.sampled_from(KINDS))
def test_emulated_sums_match_plain(d, seed, kind):
    seg, n_seg = segmentation(kind, d, seed)
    rng = np.random.default_rng(seed)
    u = rng.uniform(size=(1, d)).astype(np.float32)
    q, p = _qp(seed, (1, d))
    a, b = log_ratio_coeffs(torch.tensor(q), torch.tensor(p))
    xa = torch.where(torch.tensor(u) < torch.tensor(p), a, 0.0).numpy()
    out, _ = emulate(seg, n_seg, np.stack([xa[0], b.numpy()[0]], axis=1).astype(np.float64))
    want = segment_logw_ref(torch.tensor(u), torch.tensor(p), a, b,
                            torch.tensor(seg, dtype=torch.int64), n_seg)[0, 0].numpy()
    mag = segment_logw_ref(torch.zeros(1, d), torch.ones(1, d), a.abs(), b.abs(),
                           torch.tensor(seg, dtype=torch.int64), n_seg)[0, 0].numpy()
    got = (out[:, 0].astype(np.float32) + out[:, 1].astype(np.float32))
    assert np.all(np.abs(got - want) <= SUM_RTOL * mag + SUM_ATOL)


# ---------------------------------------------------------------------------
# The kernel's threefry (common.cuh), as the kernel computes it.
# ---------------------------------------------------------------------------


def _threefry_u32(k0, k1, x0, x1):
    """threefry2x32 of common.cuh in Python ints masked to uint32."""
    m = 0xFFFFFFFF
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0, x1 = (x0 + ks[0]) & m, (x1 + ks[1]) & m
    for i in range(5):
        for r in ROTATIONS[i & 1]:
            x0 = (x0 + x1) & m
            x1 = (((x1 << r) | (x1 >> (32 - r))) & m) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & m
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & m
    return x0, x1


def _uniform_at(key, j):
    y0, y1 = _threefry_u32(key[0], key[1], 0, j)
    return np.array([((y0 ^ y1) >> 9) | 0x3F800000], np.uint32).view(np.float32)[0] - 1.0


@pytest.mark.parametrize("seed,n_is,d,n_seg", [(0, 4, 40, 3), (7, 3, 1001, 9),
                                               (2 ** 31 + 5, 2, 17, 17)])
def test_kernel_threefry_is_prng(seed, n_is, d, n_seg):
    """Pass 1's u (row key fold_in(key, i), counter (0, e)), pass 2's Gumbel
    uniforms (counter (0, i * n_seg + s)) and pass 3's chosen element, as
    the kernel computes them, equal repro_torch.prng's draws bit for bit."""
    key = prng.PRNGKey(seed, device="cpu")
    kw = tuple(int(x) for x in key)
    u = segment_candidates(key, n_is, d).numpy()
    for i in range(n_is):
        rk = _threefry_u32(kw[0], kw[1], 0, i)
        row = np.array([_uniform_at(rk, e) for e in range(d)], np.float32)
        np.testing.assert_array_equal(row, u[i])
    gu = prng.uniform(key, (n_is, n_seg)).numpy()
    got = np.array([[_uniform_at(kw, i * n_seg + s) for s in range(n_seg)]
                    for i in range(n_is)], np.float32)
    np.testing.assert_array_equal(got, gu)


@pytest.mark.parametrize("clients,nis,d,n_seg", [(1, 1, 2 ** 32, 1), (1, 1, 2 ** 31, 1),
                                                 (2 ** 16, 2 ** 16, 2, 1), (1, 1, 5, -1)])
def test_size_checks_refuse_what_the_kernel_cannot_index(clients, nis, d, n_seg):
    """D >= 2^32 (the kernel's uint32 counters), int32 overflow of the
    buffers and a negative n_seg are refused before any launch."""
    sl._check_sizes(10, 64, 28160, 41)          # the adaptive path's shape
    with pytest.raises(ValueError, match="out of range"):
        sl._check_sizes(clients, nis, d, n_seg)
