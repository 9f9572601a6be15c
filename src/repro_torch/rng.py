"""The JAX default PRNG (threefry2x32, partitionable) reimplemented in torch.

Every draw on the reference round loop is a ``jax.random`` call: the
local-SGD batch indices, the round and device keys, the Mixup pair draw,
the FLD seed ``choice``, the channel's Bernoulli slots, the synthetic data
and the CNN init.  Reproducing the reference's histories needs the same
stream, so this module implements the installed jax's defaults
(``jax_threefry_partitionable=True``, x64 off) from ``jax/_src/prng.py``
and ``jax/_src/random.py``:

* a key is an int64 tensor of shape ``(..., 2)`` holding two uint32
  words; every function accepts a batch of keys in its leading dims and
  returns the batch in front of the drawn shape (what ``jax.vmap`` over
  keys gives);
* uint32 arithmetic runs in int64 with ``& 0xFFFFFFFF`` masking, because
  ``torch.uint32`` lacks shifts, xor and add on many backends;
* everything runs on the key's device, and no draw copies a value
  from the host to it (Python constants enter as scalars), so a
  draw issued on a side CUDA stream never waits for the card.

Integer draws and ``uniform``/``bernoulli`` are bit-exact; ``normal``,
``gumbel`` and ``exponential`` go through ``erfinv``/``log``/``log1p``,
whose last bits depend on the math library.
"""
from __future__ import annotations

import math
import struct

import torch

MASK = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & MASK


def threefry2x32(k1, k2, x1, x2):
    """The threefry2x32 block function (20 rounds) on broadcastable int64
    tensors of uint32 words.  Returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x1 = (x1 + ks[0]) & MASK
    x2 = (x2 + ks[1]) & MASK
    for i in range(5):
        for r in _ROT[i % 2]:
            x1 = (x1 + x2) & MASK
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & MASK
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & MASK
    return x1, x2


def PRNGKey(seed: int, device=None):
    """``jax.random.PRNGKey(seed)`` for a 32-bit seed: ``[0, seed]``."""
    return torch.tensor([0, int(seed) & MASK], dtype=torch.int64,
                        device=device)


def _hash(key, lo):
    """threefry of counter ``(0, lo)`` under each key of the batch:
    ``key`` (..., 2), ``lo`` (*s) -> two words of shape (..., *s)."""
    nb = lo.dim()
    if key.is_meta:   # shapes only (the dry run's parameter tree)
        w = torch.empty(key.shape[:-1] + lo.shape, dtype=torch.int64,
                        device="meta")
        return w, w
    key = key.to(torch.int64)
    k1 = key[..., 0].reshape(key.shape[:-1] + (1,) * nb)
    k2 = key[..., 1].reshape(key.shape[:-1] + (1,) * nb)
    return threefry2x32(k1, k2, torch.zeros_like(lo), lo)


def split(key, num: int = 2):
    """``jax.random.split``: (..., 2) -> (..., num, 2)."""
    lo = torch.arange(num, dtype=torch.int64, device=key.device)
    b1, b2 = _hash(key, lo)
    return torch.stack([b1, b2], dim=-1)


def fold_in(key, data: int):
    """``jax.random.fold_in``: (..., 2) -> (..., 2)."""
    lo = torch.full((1,), int(data) & MASK, dtype=torch.int64,
                    device=key.device)
    b1, b2 = _hash(key, lo)
    return torch.stack([b1[..., 0], b2[..., 0]], dim=-1)


def random_bits(key, shape, offset: int = 0):
    """32 random bits per element: (..., 2) -> (..., *shape) int64.

    ``offset`` draws elements ``offset .. offset + prod(shape) - 1`` (in
    flat order) of a larger draw from the same key, so a big array can be
    drawn in row chunks with the stream unchanged."""
    shape = tuple(shape)
    n = math.prod(shape)
    if offset + n >= 2 ** 32:
        raise NotImplementedError("more than 2**32 draws from one key")
    lo = torch.arange(offset, offset + n, dtype=torch.int64,
                      device=key.device).reshape(shape)
    b1, b2 = _hash(key, lo)
    return b1 ^ b2


def check_span(minval: int, maxval: int) -> None:
    """Refuses a :func:`randint` bound that spans 2**31 or more.
    :func:`randint` checks an int bound itself; a tensor bound is not
    read back from the card, so whoever builds it checks its largest
    value on the host with this."""
    if maxval - minval >= 2 ** 31:
        raise NotImplementedError("randint spans of 2**31 or more")


def randint(key, shape, minval: int, maxval):
    """``jax.random.randint`` (int32 range): (..., 2) -> (..., *shape).

    ``maxval`` is an int, or an integer tensor of per-row bounds over the
    leading batch dims of ``key`` (shape ``key.shape[:k]``, aligned from
    the left): jax's randint with a traced ``maxval``, as the sweep grid
    draws each point's batches under its own ``n_local`` or ``n_train``.
    A row's draws equal the int path's at the same bound.  A tensor
    bound is checked by its builder (:func:`check_span`)."""
    k = split(key, 2)
    hi = random_bits(k[..., 0, :], shape)
    lo = random_bits(k[..., 1, :], shape)
    if torch.is_tensor(maxval):
        m = maxval.to(device=hi.device, dtype=torch.int64)
        m = m.reshape(m.shape + (1,) * (hi.dim() - m.dim()))
        span = torch.where(m > minval, m - minval, 1)
    else:
        check_span(minval, maxval)
        span = maxval - minval if maxval > minval else 1
    # jax computes in uint32: both products and the sum wrap at 2**32
    # (for spans above 2**16 the multiplier wraps to 0)
    mult = ((2 ** 16 % span) ** 2 & MASK) % span
    off = ((((hi % span) * mult) & MASK) + lo % span) & MASK
    return off % span + minval


def _to_f32(v: float) -> float:
    """``v`` rounded to float32, as a Python float (a float32 tensor op
    with a Python scalar rounds the scalar to float32 first)."""
    return struct.unpack("f", struct.pack("f", v))[0]


def uniform(key, shape, minval: float = 0.0, maxval: float = 1.0,
            offset: int = 0):
    """``jax.random.uniform`` in float32: (..., 2) -> (..., *shape)."""
    bits = random_bits(key, shape, offset)
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    # jax rounds both bounds to float32 and subtracts in float32; the
    # double difference of two float32 values rounds to the same float32
    lo = _to_f32(minval)
    span = _to_f32(_to_f32(maxval) - lo)
    return torch.clamp_min(f * span + lo, lo)


def bernoulli(key, p, shape):
    """``jax.random.bernoulli`` (mode "low"): uniform < float32(p).  ``p``
    is a float, or a float32 tensor of per-row probabilities over the
    leading batch dims of ``key`` (aligned from the left)."""
    u = uniform(key, shape)
    if torch.is_tensor(p):
        return u < p.reshape(p.shape + (1,) * (u.dim() - p.dim()))
    return u < torch.tensor(p, dtype=torch.float32)


_TINY = torch.finfo(torch.float32).tiny


def gumbel(key, shape):
    """``jax.random.gumbel`` (mode "low"): -log(-log(u)), u in [tiny, 1)."""
    return -torch.log(-torch.log(uniform(key, shape, _TINY, 1.0)))


def exponential(key, shape):
    """``jax.random.exponential`` in float32: -log1p(-u), u in [0, 1)."""
    return -torch.log1p(-uniform(key, shape))


# XLA's float32 ErfInv: Giles' single-precision polynomial.
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def erfinv(x):
    """float32 inverse error function with XLA's polynomial."""
    w = -torch.log1p(-x * x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)

    def coef(i):
        return torch.where(lt, torch.tensor(_ERFINV_LT5[i], dtype=x.dtype,
                                            device=x.device),
                           torch.tensor(_ERFINV_GE5[i], dtype=x.dtype,
                                        device=x.device))

    p = coef(0)
    for i in range(1, 9):
        p = coef(i) + p * w
    out = p * x
    return torch.where(x.abs() == 1.0, x * torch.finfo(x.dtype).max, out)


_NORMAL_LO = float(torch.nextafter(torch.tensor(-1.0), torch.tensor(0.0)))
_SQRT2 = torch.tensor(math.sqrt(2.0), dtype=torch.float32)


def normal(key, shape, offset: int = 0):
    """``jax.random.normal`` in float32: sqrt(2) * erfinv(u), u in (-1, 1).
    ``offset`` as in :func:`random_bits`."""
    u = uniform(key, shape, _NORMAL_LO, 1.0, offset)
    return _SQRT2.to(u.device) * erfinv(u)


def permutation(key, n: int):
    """``jax.random.permutation(key, n)``: jax's sort-based shuffle of
    ``arange(n)`` (stable sorts on fresh 32-bit keys)."""
    rounds = math.ceil(3 * math.log(max(1, n)) / math.log(2 ** 32 - 1))
    x = torch.arange(n, dtype=torch.int64, device=key.device)
    x = x.expand(key.shape[:-1] + (n,))
    for _ in range(rounds):
        k = split(key, 2)
        key, sub = k[..., 0, :], k[..., 1, :]
        order = torch.sort(random_bits(sub, (n,)), dim=-1, stable=True)[1]
        x = torch.gather(x, -1, order)
    return x


def choice(key, n: int, shape, replace: bool = True):
    """``jax.random.choice(key, n, shape, replace)`` without ``p``."""
    shape = tuple(shape)
    draws = math.prod(shape)
    if replace:
        return randint(key, shape, 0, n)
    if draws > n:
        raise ValueError(f"Cannot take a larger sample (size {draws}) than "
                         f"population (size {n}) when 'replace=False'")
    perm = permutation(key, n)[..., :draws]
    return perm.reshape(key.shape[:-1] + shape)
