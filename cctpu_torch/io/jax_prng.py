"""numpy copy of ``jax.random.normal(jax.random.PRNGKey(seed), shape)``.

The SMILES embedding starts its force-field minimization from a seeded
normal draw. cctpu draws it with ``jax.random`` (threefry2x32, the
partitionable 64-bit layout, x64 on), so the port draws the same numbers
here without JAX: the same seed gives the same start, and the same SMILES
the same molecule.

Layout of the f64 draw: key ``[seed >> 32, seed & 0xffffffff]``; the
counters are a 64-bit iota over the flattened shape, split into hi and lo
32-bit words; threefry2x32 of (hi, lo) gives two words that join as
``hi << 32 | lo``; the top 52 bits become a float in [1, 2), which is
mapped onto [nextafter(-1, 0), 1) and then through ``sqrt(2) * erfinv``.
"""

from __future__ import annotations

import numpy as np
from scipy.special import erfinv

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)


def _rotl(x, r):
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(key, x0, x1):
    """Threefry-2x32 with 20 rounds (five groups of four), as JAX's."""
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = x0 + ks[0]
    x1 = x1 + ks[1]
    for g in range(5):
        for r in _ROTATIONS[g % 2]:
            x0 = x0 + x1
            x1 = _rotl(x1, r) ^ x0
        x0 = x0 + ks[(g + 1) % 3]
        x1 = x1 + ks[(g + 2) % 3] + np.uint32(g + 1)
    return x0, x1


def random_bits64(seed: int, n: int) -> np.ndarray:
    """``n`` 64-bit words of ``jax.random.PRNGKey(seed)``."""
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    key = (seed >> 32, seed & 0xFFFFFFFF)
    i = np.arange(n, dtype=np.uint64)
    hi = (i >> np.uint64(32)).astype(np.uint32)
    lo = (i & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    with np.errstate(over="ignore"):
        b0, b1 = threefry2x32(key, hi, lo)
    return (b0.astype(np.uint64) << np.uint64(32)) | b1.astype(np.uint64)


def normal(seed: int, shape) -> np.ndarray:
    """``jax.random.normal(jax.random.PRNGKey(seed), shape)`` in f64."""
    n = int(np.prod(shape))
    bits = random_bits64(seed, n)
    one = np.array(1.0).view(np.uint64)
    f = ((bits >> np.uint64(12)) | one).view(np.float64) - 1.0
    lo = np.nextafter(-1.0, 0.0)
    u = np.maximum(lo, f * (1.0 - lo) + lo)
    return (np.sqrt(2.0) * erfinv(u)).reshape(shape)
