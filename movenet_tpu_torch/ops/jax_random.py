"""``jax.random`` draws reproduced on the host, for streams that must give
the JAX package's codes.

The JAX samplers draw a sampled code with
``jax.random.categorical(jax.random.fold_in(PRNGKey(seed), t), scores)``.
This module computes the same draw from the same bit layout: the
threefry2x32 block cipher, ``fold_in``, partitionable ``random_bits``
(one 64-bit counter per element, the two output words xor-ed), uniform
floats built from the top 23 bits, Gumbel noise of mode "low", and a
first-index argmax.  Integer steps are bit-exact in numpy uint32.  The
two logarithms of the Gumbel transform are float32 library calls; they
may differ from XLA's by one unit in the last place, which moves a draw
only at an exact tie of scores.
"""

from __future__ import annotations

import numpy as np
import torch

_MASK32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(k1, k2, x0: np.ndarray, x1: np.ndarray):
    """The threefry2x32 hash with 20 rounds of key (k1, k2) over counter
    words (x0, x1); returns the two output words."""
    k1 = np.uint32(k1)
    k2 = np.uint32(k2)
    ks = (k1, k2, k1 ^ k2 ^ np.uint32(0x1BD11BDA))
    x0 = np.asarray(x0, np.uint32) + ks[0]
    x1 = np.asarray(x1, np.uint32) + ks[1]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = x0 + x1
            x1 = _rotl(x1, r)
            x1 = x0 ^ x1
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def PRNGKey(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)``: the key words (0, seed mod 2^32)."""
    return np.array([0, int(seed) & _MASK32], np.uint32)


def fold_in(key: np.ndarray, data: int) -> np.ndarray:
    """``jax.random.fold_in(key, data)``."""
    x0, x1 = threefry2x32(key[0], key[1],
                          np.zeros(1, np.uint32),
                          np.array([int(data) & _MASK32], np.uint32))
    return np.array([x0[0], x1[0]], np.uint32)


def random_bits(key: np.ndarray, shape) -> np.ndarray:
    """32-bit ``jax.random.bits`` with ``jax_threefry_partitionable``."""
    size = int(np.prod(shape, dtype=np.int64))
    idx = np.arange(size, dtype=np.uint64)
    hi = (idx >> np.uint64(32)).astype(np.uint32)
    lo = (idx & np.uint64(_MASK32)).astype(np.uint32)
    b0, b1 = threefry2x32(key[0], key[1], hi, lo)
    return (b0 ^ b1).reshape(shape)


def uniform(key: np.ndarray, shape, minval: float = 0.0,
            maxval: float = 1.0) -> np.ndarray:
    """float32 ``jax.random.uniform``: 23 random mantissa bits in [1, 2),
    minus 1, scaled to [minval, maxval)."""
    bits = random_bits(key, shape)
    one = np.array(1.0, np.float32).view(np.uint32)
    floats = ((bits >> np.uint32(9)) | one).view(np.float32) \
        - np.float32(1.0)
    lo, hi = np.float32(minval), np.float32(maxval)
    return np.maximum(lo, floats * (hi - lo) + lo)


def gumbel(key: np.ndarray, shape) -> np.ndarray:
    """float32 ``jax.random.gumbel`` of mode "low"."""
    tiny = np.finfo(np.float32).tiny
    u = torch.from_numpy(uniform(key, shape, minval=tiny, maxval=1.0))
    return (-torch.log(-torch.log(u))).numpy()


def categorical(key: np.ndarray, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical(key, logits, axis=-1)`` for float32
    logits (..., C): argmax of Gumbel noise plus logits, first index on
    ties.  Returns int64 indices on the logits' device."""
    noise = torch.from_numpy(gumbel(key, tuple(logits.shape)))
    return torch.argmax(noise.to(logits.device) + logits, dim=-1)
