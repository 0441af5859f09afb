"""Threefry-2x32 counter PRNG with the bits of ``jax.random`` (jax 0.9).

BiCompFL's shared randomness *is* the algorithm: encoder and decoder derive
the same MRC candidates from the same key, and the port must derive the
candidates the reference derives.  So the port reproduces the reference's
generator bit for bit instead of using ``torch.Generator``.

Semantics follow ``jax._src.prng`` under ``jax_threefry_partitionable=True``
(the jax 0.9 default):

* a key is an int64 tensor ``(..., 2)`` holding two uint32 words;
* ``PRNGKey(seed)`` is ``[0, seed mod 2**32]`` (jax's x32 mode);
* ``fold_in(k, d) = threefry2x32(k, (0, d))``;
* ``split(k, shape)[i] = threefry2x32(k, (hi(i), lo(i)))`` over the
  row-major 64-bit iota of ``shape`` (the "foldlike" split);
* 32 random bits at flat position ``j`` are ``y0 ^ y1`` of
  ``threefry2x32(k, (hi(j), lo(j)))``;
* ``uniform`` puts the top 23 bits in the mantissa of a float in [1, 2).

Every function is batched over the leading axes of its key: a key of shape
``(K..., 2)`` gives outputs of shape ``(K..., *shape)``, which replaces
``jax.vmap`` over keys.

Every draw goes through ``kernels.ops.threefry_draw`` (``draw_int64``'s
arguments): for a key on the card that is one launch of a hand-written
kernel in native uint32 (``kernels/csrc/threefry_draw.cu``); for a key on
the CPU or ``meta`` it is ``draw_int64``, where uint32 arithmetic is done in
int64 and masked to 32 bits after every add.  Both give the same bits.
"""
from __future__ import annotations

import math
import numbers
from typing import Sequence, Union

import torch

from repro_torch import resolve_device

MASK32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA

Shape = Union[int, Sequence[int]]


def _shape(shape: Shape) -> tuple:
    return (int(shape),) if isinstance(shape, int) else tuple(int(s) for s in shape)


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & MASK32) | (x >> (32 - r))


def threefry2x32(k0, k1, x0, x1):
    """The Threefry-2x32 block function (20 rounds), broadcast elementwise.

    All arguments are int64 tensors of uint32 words; returns ``(y0, y1)``.
    """
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & MASK32
    x1 = (x1 + ks[1]) & MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK32
    return x0, x1


def PRNGKey(seed: int, device="cuda") -> torch.Tensor:
    """The raw threefry key of an integer seed: ``[0, seed mod 2**32]``.

    Every other draw runs on its key's device, so this is where a run picks
    the card or, with ``device="cpu"``, the CPU.
    """
    return torch.tensor([0, int(seed) & MASK32], dtype=torch.int64,
                        device=resolve_device(device))


def _key_words(key: torch.Tensor, n_new: int):
    """The two key words, with ``n_new`` trailing axes for broadcasting."""
    k0, k1 = key[..., 0], key[..., 1]
    idx = (...,) + (None,) * n_new
    return k0[idx], k1[idx]


# What each kind of draw writes (``draw_int64``'s ``out``).
DRAW_DTYPES = {"words": torch.int64, "bits": torch.int64, "unit": torch.float32,
               "bernoulli": torch.bool}


def draw_dims(key: torch.Tensor, at, ndim: int, out: str, p=None) -> tuple:
    """``(lead, sample)`` of a draw (``draw_int64``'s arguments): its batch
    shape, the key's batch axes broadcast against those of ``at`` or ``p``,
    and its sample shape; the output is ``lead + sample`` (``+ (2,)`` for
    words)."""
    batch = tuple(key.shape[:-1])
    if out == "bernoulli":
        kd = key.dim() - 1
        return tuple(torch.broadcast_shapes(batch, p.shape[:kd])), tuple(p.shape[kd:])
    if isinstance(at, tuple):
        return batch, at
    if isinstance(at, int):
        return batch, ()
    cut = at.dim() - ndim
    return tuple(torch.broadcast_shapes(batch, at.shape[:cut])), tuple(at.shape[cut:])


def draw_int64(key: torch.Tensor, at, ndim: int = 0, out: str = "bits",
               p: torch.Tensor = None) -> torch.Tensor:
    """One draw in int64 torch ops: the plain route of ``ops.threefry_draw``.

    ``at`` is a shape (positions ``0 .. prod(at) - 1``, row-major), an int
    (one position) or an int64 tensor of positions whose last ``ndim`` axes
    are sample axes; the key's batch axes broadcast against the rest.  The
    counter of position j is ``(hi(j), lo(j))``.  ``out``: ``"words"``
    (``(y0, y1)`` on a trailing axis), ``"bits"`` (``y0 ^ y1``), ``"unit"``
    (the float in [0, 1)) or ``"bernoulli"`` (``unit < p``).
    """
    if isinstance(at, tuple):
        counts = torch.arange(math.prod(at), dtype=torch.int64, device=key.device).reshape(at)
        ndim = len(at)
    elif isinstance(at, int):
        # A fill, not a host-to-device copy: safe inside a captured graph.
        counts = torch.full((), at, dtype=torch.int64, device=key.device)
    else:
        counts = at
    k0, k1 = _key_words(key, ndim)
    y0, y1 = threefry2x32(k0, k1, counts >> 32, counts & MASK32)
    if out == "words":
        return torch.stack(torch.broadcast_tensors(y0, y1), dim=-1)
    bits = y0 ^ y1
    if out == "bits":
        return bits
    floats = _bits_to_unit_float(bits)
    return floats if out == "unit" else floats < p


def _draw(key: torch.Tensor, at, ndim: int = 0, out: str = "bits", p=None) -> torch.Tensor:
    from repro_torch.kernels import ops   # kernels/mrc_weights.py imports this module
    return ops.threefry_draw(key, at, ndim, out, p)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``, broadcast over key batch axes and ``data``.

    ``key`` is ``(K..., 2)``; ``data`` is an int or an integer tensor whose
    shape broadcasts against ``K...``.  Returns ``(broadcast..., 2)``.
    """
    if isinstance(data, numbers.Integral):
        return _draw(key, int(data) & MASK32, 0, "words")
    d = torch.as_tensor(data, dtype=torch.int64, device=key.device) & MASK32
    return _draw(key, d, 0, "words")


def split(key: torch.Tensor, num: Shape = 2) -> torch.Tensor:
    """``jax.random.split``: ``(K..., 2)`` -> ``(K..., *num, 2)``."""
    return _draw(key, _shape(num), 0, "words")


def random_bits(key: torch.Tensor, shape: Shape) -> torch.Tensor:
    """32 random bits per element: ``(K..., 2)`` -> int64 ``(K..., *shape)``."""
    return _draw(key, _shape(shape), 0, "bits")


def _bits_to_unit_float(bits: torch.Tensor) -> torch.Tensor:
    """Top 23 bits as the mantissa of a float in [1, 2), minus 1: [0, 1)."""
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return f - 1.0


def uniform_at(key: torch.Tensor, counts: torch.Tensor, ndim: int = 1) -> torch.Tensor:
    """Selected elements of ``uniform(key, shape)``, by flat position.

    ``uniform(key, shape).reshape(..., -1)[..., j] == uniform_at(key, j)``:
    the decoder regenerates one candidate row without drawing the others.
    """
    return _draw(key, counts, ndim, "unit")


def uniform(key: torch.Tensor, shape: Shape = (), minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform`` in float32: ``(K..., 2)`` -> ``(K..., *shape)``.

    Bit-exact for the default ``[0, 1)``.  For another range the affine map
    ``floats * (maxval - minval) + minval`` rounds twice here; XLA may
    contract it into one FMA, so such ranges agree to within 1 ulp.
    """
    floats = _draw(key, _shape(shape), 0, "unit")
    if minval == 0.0 and maxval == 1.0:
        return floats  # floats * 1 + 0, clamped at 0: the identity
    lo = torch.full((), minval, dtype=torch.float32, device=key.device)
    hi = torch.full((), maxval, dtype=torch.float32, device=key.device)
    return torch.maximum(lo, floats * (hi - lo) + lo)


def bernoulli(key: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """``jax.random.bernoulli(key, p)`` (bool), batched over key axes.

    ``key`` is ``(K..., 2)``; ``p`` is ``(K..., *S)`` and each key draws
    the ``S``-shaped sample that ``jax.random.bernoulli(k, p_k)`` draws:
    ``uniform(key, S) < p``, compared where it is drawn.
    """
    return _draw(key, tuple(p.shape[key.dim() - 1:]), 0, "bernoulli", p)


def _mul32(a: torch.Tensor, b) -> torch.Tensor:
    """``(a * b) mod 2**32`` for uint32 words held in int64, overflow-free."""
    lo = a * (b & 0xFFFF)
    hi = ((a * (b >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK32


def randint(key: torch.Tensor, shape: Shape, minval: int, maxval: int) -> torch.Tensor:
    """``jax.random.randint`` for int32 (returned as int64).

    The reference's two-draw algorithm: 64 random bits per value, folded
    into ``[minval, maxval)`` by a modulus that keeps the bias small.
    """
    shape = _shape(shape)
    minval, maxval = int(minval), int(maxval)
    ks = split(key, 2)
    higher = random_bits(ks[..., 0, :], shape)
    lower = random_bits(ks[..., 1, :], shape)
    span = (maxval - minval) & MASK32 if maxval > minval else 1
    multiplier = (2 ** 16) % span
    multiplier = ((multiplier * multiplier) & MASK32) % span
    offset = (_mul32(higher % span, multiplier) + lower % span) & MASK32
    offset = offset % span
    out = (minval + offset) & MASK32
    return torch.where(out >= 2 ** 31, out - 2 ** 32, out)  # int32 wrap


def permutation(key: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.permutation(key, n)``: a shuffle of ``arange(n)`` (int64).

    jax's ``_shuffle``: ``ceil(3 ln n / ln(2**32 - 1))`` rounds, each of
    which splits the key, draws 32 random bits per element and sorts the
    elements by them, stably.  Batched over the key's leading axes:
    ``(K..., 2)`` -> ``(K..., n)``.
    """
    n = int(n)
    x = torch.arange(n, dtype=torch.int64, device=key.device).expand(key.shape[:-1] + (n,))
    for _ in range(math.ceil(3 * math.log(max(1, n)) / math.log(MASK32))):
        ks = split(key, 2)
        key, sub = ks[..., 0, :], ks[..., 1, :]
        order = torch.sort(random_bits(sub, (n,)), dim=-1, stable=True).indices
        x = torch.take_along_dim(x, order, dim=-1)
    return x


def choice(key: torch.Tensor, n: int, shape: Shape = (), replace: bool = True) -> torch.Tensor:
    """``jax.random.choice(key, n, shape, replace)`` from ``arange(n)``, uniform
    (no ``p``), as int64; batched: ``(K..., 2)`` -> ``(K..., *shape)``.

    Without replacement it is the first ``prod(shape)`` entries of
    ``permutation(key, n)``, as in jax; with replacement ``randint``.
    """
    shape = _shape(shape)
    k = math.prod(shape)
    if replace:
        return randint(key, shape, 0, n)
    if k > n:
        raise ValueError(f"Cannot take a larger sample (size {k}) than population "
                         f"(size {n}) when 'replace=False'")
    return permutation(key, n)[..., :k].reshape(key.shape[:-1] + shape)


def normal(key: torch.Tensor, shape: Shape = ()) -> torch.Tensor:
    """``jax.random.normal`` in float32: ``sqrt(2) * erfinv(u)``.

    ``u`` is bit-exact; ``erfinv`` is torch's, not XLA's polynomial, so the
    result agrees with the reference to a few ulp (the tests state the
    bound), and its sign agrees exactly.
    """
    lo = float(torch.nextafter(torch.tensor(-1.0), torch.tensor(0.0)))
    u = uniform(key, shape, lo, 1.0)
    sqrt2 = torch.full((), math.sqrt(2.0), dtype=torch.float32, device=key.device)
    return sqrt2 * torch.erfinv(u)


def gumbel(key: torch.Tensor, shape: Shape = ()) -> torch.Tensor:
    """``jax.random.gumbel`` in float32 (the default "low" mode):
    ``-log(-log(uniform(key, shape, tiny, 1)))``.

    The uniforms are bit-exact; torch's ``log`` may differ from XLA's in
    the last ulp.
    """
    tiny = torch.finfo(torch.float32).tiny
    return -torch.log(-torch.log(uniform(key, shape, tiny, 1.0)))


def categorical(key: torch.Tensor, logits: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """``jax.random.categorical`` (with replacement): the Gumbel-max sample,
    ``argmax(gumbel(key, logits.shape) + logits, axis)`` (int64)."""
    return torch.argmax(gumbel(key, logits.shape) + logits, dim=axis)
