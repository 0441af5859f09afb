"""``prng``'s draw kernel (``csrc/threefry_draw.cu``), its design emulated on the CPU.

The kernel cannot run here, but its design can: ``emulate`` walks the
launch that ``kernels.threefry_draw`` sets up (``layout``, ``geometry``,
``vector_path``) block by block and thread by thread, reads every operand
through its pointer and row stride, draws each thread's P consecutive
positions with Threefry-2x32 in numpy's native uint32 arithmetic (the
kernel's, not ``prng``'s masked int64) and writes the epilogue as the
kernel does, the 16-byte path packing sixteen bools into four
little-endian words.  The result is held bit for bit to ``prng``'s int64
route (``prng.draw_int64``, what every ``prng`` function gives on the
CPU), and every output element must be written exactly once.  No JAX:
``tests/test_torch_prng.py`` ties ``prng`` to ``jax.random``.
"""
import numpy as np
import pytest
import torch

from repro_torch import prng
from repro_torch.fl.nets import make_mlp
from repro_torch.fl.tasks import make_mask_task
from repro_torch.kernels import build, ops
from repro_torch.kernels import threefry_draw as tfd

CPU = "cpu"
ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def threefry_u32(k0, k1, x0, x1):
    """common.cuh's threefry2x32 on numpy uint32 arrays (wrapping adds)."""
    k2 = k0 ^ k1 ^ np.uint32(0x1BD11BDA)
    ks = (k0, k1, k2)
    x0, x1 = x0 + k0, x1 + k1
    for i in range(5):
        for r in ROTATIONS[i % 2]:
            x0 = x0 + x1
            x1 = ((x1 << np.uint32(r)) | (x1 >> np.uint32(32 - r))) ^ x0
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def _storage(t):
    """The whole storage under ``t`` as a flat numpy array: what the
    kernel's pointer plus offsets reads."""
    flat = torch.empty(0, dtype=t.dtype).set_(t.untyped_storage())
    return flat.numpy(), t.storage_offset()


def emulate(key, at, ndim, out, p=None):
    """The kernel's launch for one draw, thread by thread; returns the
    output tensor and how often each element was written."""
    lay = tfd.layout(key, at, ndim, out, p)
    res = torch.zeros(lay.shape, dtype=prng.DRAW_DTYPES[out])
    width = 2 if out == "words" else 1
    flat = res.view(torch.uint8).numpy().reshape(-1) if out == "bernoulli" \
        else res.numpy().reshape(-1)
    writes = np.zeros(flat.size, np.int64)
    if lay.rows * lay.cols == 0:
        return res, writes
    vec = tfd.vector_path(lay, res, out)
    P = tfd.POSITIONS[out]
    tx, ty, gx, gy = tfd.geometry(lay.rows, lay.cols, out)
    keys, k_off = _storage(lay.keys)
    pos = p_arr = None
    if lay.pos is not None:
        pos, pos_off = _storage(lay.pos)
    if lay.p is not None:
        p_arr, p_off = _storage(lay.p)
    # every thread of the grid: (blockIdx.x, threadIdx.x) -> c0, (blockIdx.y, threadIdx.y) -> row
    bx, x, by, y = np.meshgrid(np.arange(gx), np.arange(tx), np.arange(gy), np.arange(ty),
                               indexing="ij")
    c0 = ((bx * tx + x) * P).reshape(-1)
    r = (by * ty + y).reshape(-1)
    live = c0 < lay.cols                     # the rest return at once
    c0, r = c0[live], r[live]
    n = np.full(c0.shape, P) if vec else np.minimum(P, lay.cols - c0)
    while True:
        on = r < lay.rows
        if not on.any():
            break
        tc0, tr, tn = c0[on], r[on], n[on]
        ko = k_off + tr * tfd.row_stride(lay.keys)
        k0 = keys[ko].astype(np.uint32)
        k1 = keys[ko + 1].astype(np.uint32)
        i = np.arange(P)[None, :]
        col = tc0[:, None] + i
        held = i < tn[:, None]
        if pos is not None:
            at_ = pos_off + tr[:, None] * tfd.row_stride(lay.pos) + col
            j = np.where(held, pos[np.where(held, at_, 0)], 0).astype(np.int64).view(np.uint64)
        else:
            j = np.uint64(lay.base) + col.astype(np.uint64)
        y0, y1 = threefry_u32(np.broadcast_to(k0[:, None], j.shape),
                              np.broadcast_to(k1[:, None], j.shape),
                              (j >> np.uint64(32)).astype(np.uint32), j.astype(np.uint32))
        first = tr[:, None] * lay.cols + col                 # output element
        if out == "words":
            vals = np.stack([y0, y1], -1).astype(np.int64)
        elif out == "bits":
            vals = (y0 ^ y1).astype(np.int64)
        else:
            u = (((y0 ^ y1) >> np.uint32(9)) | np.uint32(0x3F800000)).view(np.float32) \
                - np.float32(1.0)
            if out == "unit":
                vals = u
            else:
                q = p_arr[np.where(held, p_off + tr[:, None] * tfd.row_stride(lay.p) + col, 0)]
                vals = (u < q).astype(np.uint8)
                if vec:    # four words a thread, byte b of word k = position 4 k + b
                    words = (vals.reshape(-1, P // 4, 4).astype(np.uint32)
                             << (8 * np.arange(4, dtype=np.uint32))).sum(-1, dtype=np.uint32)
                    vals = words.astype("<u4").view(np.uint8).reshape(-1, P)
        idx = first[held]
        if width == 2:
            idx = np.stack([2 * idx, 2 * idx + 1], -1)
            flat[idx] = vals[held]
        else:
            flat[idx] = vals[held]
        np.add.at(writes, idx.reshape(-1), 1)
        r = r + gy * ty
    return res, writes


def _same_bits(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype
    if got.dtype == torch.float32:
        got, want = got.view(torch.int32), want.view(torch.int32)
    assert torch.equal(got, want)


def _keys(seed, *batch):
    k = prng.PRNGKey(seed, device=CPU)
    return prng.split(k, batch) if batch else k


def _probs(seed, *shape):
    return prng.uniform(_keys(seed + 1000), shape)


def _case(name):
    """(key, at, ndim, out, p) of the named case."""
    g = torch.Generator().manual_seed(7)
    if name == "bernoulli-fl-rows":          # the STE's shape, cut: keys (n, 2) strided
        mks = _keys(1, 3, 5)[:, 2]
        return mks, (256,), 0, "bernoulli", _probs(1, 3, 256)
    if name == "bernoulli-ragged":           # cols % 16 != 0: the masked path
        return _keys(2, 4), (203,), 0, "bernoulli", _probs(2, 4, 203)
    if name == "bernoulli-one-key":          # key (2,), p (4, 64): one row of 256
        return _keys(3), (4, 64), 0, "bernoulli", _probs(3, 4, 64)
    if name == "bernoulli-broadcast-key":    # key (1, 2) against p (5, 48): stride 0
        return _keys(4, 1), (48,), 0, "bernoulli", _probs(4, 5, 48)
    if name == "bernoulli-broadcast-p":      # p (1, 32) against keys (6, 2)
        return _keys(5, 6), (32,), 0, "bernoulli", _probs(5, 1, 32)
    if name == "bernoulli-transposed-p":     # p a transposed view: copied
        return _keys(6, 40), (24,), 0, "bernoulli", _probs(6, 24, 40).t()
    if name == "bernoulli-edges":            # p 0, 1, NaN, the uniforms themselves
        k = _keys(7, 2)
        p = prng.draw_int64(k, (64,), 0, "unit").clone()
        p[:, :8] = torch.tensor([0.0, 1.0, float("nan"), -1.0, 2.0, 0.5, 1e-30, 0.999999])
        return k, (64,), 0, "bernoulli", p
    if name == "unit-batched":               # uniform: keys (2, 3, 2), shape (5, 3, 11)
        return _keys(8, 2, 3), (5, 3, 11), 0, "unit", None
    if name == "unit-wide":                  # one row of 8 x 300 threads: blocks of 256
        return _keys(9), (2400,), 0, "unit", None
    if name == "bits":                       # random_bits (n, steps x bs), P 4
        return _keys(10, 3), (7, 64), 0, "bits", None
    if name == "bits-ragged":
        return _keys(11, 2), (130,), 0, "bits", None
    if name == "words-split":                # split(keys (10, 2), 2)
        return _keys(12, 10), (2,), 0, "words", None
    if name == "words-split-shape":          # split(key, (2, 3, 24)): the 16-byte path
        return _keys(13), (2, 3, 24), 0, "words", None
    if name == "words-fold-int":             # fold_in(keys, 2^32 - 1): base + 0
        return _keys(14, 4), 2 ** 32 - 1, 0, "words", None
    if name == "words-fold-tensor":          # fold_in(key, ids): key broadcast over ids
        return _keys(15), torch.arange(7) * 977 & prng.MASK32, 0, "words", None
    if name == "words-fold-blocks":          # fold_in(key[..., None, :], ids): keys copied
        return _keys(16, 3)[:, None, :], torch.arange(5), 0, "words", None
    if name == "unit-at-high":               # positions past 2^32 (hi word != 0)
        counts = torch.cat([torch.arange(2 ** 32 - 40, 2 ** 32 + 40),
                            torch.arange(2 ** 40 + 3, 2 ** 40 + 51)])
        return _keys(17, 3), counts, 1, "unit", None
    if name == "unit-at-range":              # the sign's range [k 2^24, (k + 1) 2^24), cut
        lo = 135 * 2 ** 24
        return _keys(18), torch.arange(lo, lo + 4096), 1, "unit", None
    if name == "unit-at-unaligned":          # positions 8 bytes into their storage
        counts = torch.arange(2 ** 33, 2 ** 33 + 65)[1:]
        return _keys(19), counts, 1, "unit", None
    if name == "unit-at-rows":               # the decoder: keys (B, 2), rows (N, B, size)
        rows = torch.randint(0, 64, (2, 5), generator=g)
        return _keys(20, 5), rows[..., None] * 16 + torch.arange(16), 1, "unit", None
    if name == "bits-at-per-key":            # ndim 0: one position per key
        return _keys(21, 6), torch.arange(6) * 3 + 2 ** 32, 0, "bits", None
    if name == "empty":
        return _keys(22, 3), (0,), 0, "unit", None
    raise KeyError(name)


CASES = ["bernoulli-fl-rows", "bernoulli-ragged", "bernoulli-one-key",
         "bernoulli-broadcast-key", "bernoulli-broadcast-p", "bernoulli-transposed-p",
         "bernoulli-edges", "unit-batched", "unit-wide", "bits", "bits-ragged", "words-split",
         "words-split-shape", "words-fold-int", "words-fold-tensor", "words-fold-blocks",
         "unit-at-high", "unit-at-range", "unit-at-unaligned", "unit-at-rows",
         "bits-at-per-key", "empty"]


@pytest.mark.parametrize("name", CASES)
def test_emulated_kernel_is_prng_bit_for_bit(name):
    key, at, ndim, out, p = _case(name)
    got, writes = emulate(key, at, ndim, out, p)
    assert (writes == 1).all(), "every output element written exactly once"
    _same_bits(got, prng.draw_int64(key, at, ndim, out, p))


@pytest.mark.parametrize("cap", [1, 2, 3])
@pytest.mark.parametrize("out", ["words", "bits", "unit", "bernoulli"])
def test_rows_past_the_grid_are_walked_grid_stride(monkeypatch, cap, out):
    """More rows than blocks_y x threads_y (65535 x 8 on the card; a cap of
    a few here): each thread walks its rows by the grid's row span."""
    monkeypatch.setattr(tfd, "MAX_GRID_Y", cap)
    key = _keys(30, 70)
    p = _probs(30, 70, 3) if out == "bernoulli" else None
    assert tfd.geometry(70, 3, out)[3] == cap
    got, writes = emulate(key, (3,), 0, out, p)
    assert (writes == 1).all()
    _same_bits(got, prng.draw_int64(key, (3,), 0, out, p))


@pytest.mark.parametrize("out", tfd.EPILOGUES)
def test_positions_are_the_kernel_sources_and_fill_16_byte_stores(out):
    """``POSITIONS`` is the table ``csrc/threefry_draw.cu`` compiles, read
    from it, and a thread's P outputs come to whole 16-byte vectors."""
    assert len(tfd.POSITIONS) == len(tfd.EPILOGUES)
    table = ", ".join(str(tfd.POSITIONS[o]) for o in tfd.EPILOGUES)
    assert f"kPositions[] = {{{table}}}" in build.source(tfd.NAME).read_text()
    width = 2 if out == "words" else 1
    assert tfd.POSITIONS[out] * width * prng.DRAW_DTYPES[out].itemsize % 16 == 0


@pytest.mark.parametrize("rows,cols,out,want", [
    (10, 203264, "bernoulli", (256, 1, 50, 10)),    # the STE's mask
    (1, 2 ** 24, "unit", (256, 1, 8192, 1)),          # one range of the sign
    (10, 2, "words", (32, 8, 1, 2)),                  # split(keys, 2)
    (1588, 128, "unit", (32, 8, 1, 199)),             # a decoder's rows
    (5, 1000, "bits", (256, 1, 1, 5)),
    (3, 520, "unit", (128, 2, 1, 2)),
    (200000, 1, "bits", (32, 8, 1, 25000)),
    (600000, 1, "bits", (32, 8, 1, 65535)),           # rows walked grid-stride
])
def test_geometry(rows, cols, out, want):
    assert tfd.geometry(rows, cols, out) == want


@pytest.mark.parametrize("name,vec", [("bernoulli-fl-rows", True), ("bernoulli-ragged", False),
                                      ("unit-at-range", True), ("unit-at-unaligned", False),
                                      ("words-split", False), ("words-split-shape", True),
                                      ("unit-wide", True), ("bits", True),
                                      ("bits-ragged", False)])
def test_vector_path_rule(name, vec):
    key, at, ndim, out, p = _case(name)
    lay = tfd.layout(key, at, ndim, out, p)
    res = torch.empty(lay.shape, dtype=prng.DRAW_DTYPES[out])
    assert tfd.vector_path(lay, res, out) == vec


def test_layout_takes_views_where_it_can():
    """The STE's strided keys and the sign's positions are read in place;
    only a key batch that no single row stride spans is copied."""
    mks = _keys(40, 3, 5)[:, 2]
    lay = tfd.layout(mks, (256,), 0, "bernoulli", _probs(40, 3, 256))
    assert lay.keys.data_ptr() == mks.data_ptr() and tfd.row_stride(lay.keys) == 10
    counts = torch.arange(4096)
    lay = tfd.layout(_keys(41), counts, 1, "unit")
    assert lay.pos.data_ptr() == counts.data_ptr() and (lay.rows, lay.cols) == (1, 4096)
    lay = tfd.layout(_keys(42), torch.arange(7), 0, "words")
    assert tfd.row_stride(lay.keys) == 0 and (lay.rows, lay.cols) == (7, 1)
    lay = tfd.layout(_keys(43, 3)[:, None, :], torch.arange(5), 0, "words")
    assert lay.keys.is_contiguous() and lay.keys.shape == (15, 2)


def test_cpu_draws_launch_nothing():
    """On the CPU every prng draw and a MaskTask's local training take the
    int64 route: the kernel's count stays where it was."""
    before = ops.threefry_draw.launches
    key = _keys(50)
    prng.randint(key, (4, 5), 0, 7)
    prng.bernoulli(prng.split(key, 2), torch.full((2, 9), 0.3))
    prng.uniform_at(key, torch.arange(5))
    prng.permutation(key, 9)
    prng.normal(key, (3,))
    net = make_mlp(in_dim=16, widths=(8,), signed_constant=True, device=CPU)
    x = torch.rand(20, 4, 4, 1, generator=torch.Generator().manual_seed(0))
    y = torch.arange(20) % 10
    task = make_mask_task(net, prng.fold_in(key, 2), x, y, local_epochs=1, batch_size=5)
    q = task.local_train(torch.full((2, task.d), 0.5), x.reshape(2, 10, 4, 4, 1),
                         y.reshape(2, 10), prng.split(key, 2))
    assert q.shape == (2, task.d) and bool(torch.isfinite(q).all())
    assert ops.threefry_draw.launches == before
