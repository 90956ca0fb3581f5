"""The JAX package's PRNG key arithmetic, in numpy, so that a train
state's `rng` (and a checkpoint's ``.rng`` leaf) is the JAX one bit for
bit.

A key is a raw ``uint32[2]``, as `jax.random.PRNGKey` makes it under the
default threefry-2x32 implementation; `fold_in(key, data)` hashes the
32-bit `data` into it with the 20-round threefry-2x32 block cipher, as
`jax.random.fold_in` does on such a key.
"""

from __future__ import annotations

import numpy as np

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def prng_key(seed: int) -> np.ndarray:
    """`jax.random.PRNGKey(seed)`: (high word, low word) of the seed."""
    seed = int(seed)
    return np.array([(seed >> 32) & _MASK, seed & _MASK], dtype=np.uint32)


def _rotl(v: int, r: int) -> int:
    return ((v << r) | (v >> (32 - r))) & _MASK


def _threefry_2x32(key, x0: int, x1: int) -> tuple[int, int]:
    """One threefry-2x32 block: 20 rounds, a key injection every four."""
    k0, k1 = int(key[0]), int(key[1])
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _MASK
    return x0, x1


def fold_in(key, data) -> np.ndarray:
    """`jax.random.fold_in(key, data)` on a raw ``uint32[2]`` key: the
    block of the key over the counter (0, data)."""
    return np.array(_threefry_2x32(key, 0, int(data) & _MASK),
                    dtype=np.uint32)
