"""Threefry-2x32 keys and uniform draws, bit for bit as `jax.random` makes
them (jax 0.9.0, `jax_threefry_partitionable=True`, its default).

The random placement policy scores rows by `jax.random.uniform(key,
(R,))` under keys made by `PRNGKey`, `split` and `fold_in`.  The port
computes the same 32-bit words with int64 tensors masked to 32 bits (add,
shift, xor and and behave alike on the CPU and the card), so a draw is a
pure function of its key and its index on every device.

A key is an int64 tensor ``[..., 2]`` holding two uint32 words; every
function here is batched over the leading axes.  Draw ``j`` of a key
depends only on ``(key, j)``: the first R draws of a longer draw are the
R-row draw, so padded rows leave the real rows' draws unchanged.
"""
from __future__ import annotations

import torch

_MASK = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_ONE_BITS = 0x3F800000   # 1.0f: the exponent a mantissa of random bits takes


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 hash (20 rounds) of the counters ``(x1, x2)``
    under the key ``(k1, k2)``, as jax's unrolled lowering computes it.
    Arguments are int64 tensors holding uint32 values and broadcast
    against each other; returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = (x1 + ks[0]) & _MASK
    x2 = (x2 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & _MASK
            x2 = x1 ^ (((x2 << r) | (x2 >> (32 - r))) & _MASK)
        x1 = (x1 + ks[(i + 1) % 3]) & _MASK
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x1, x2


def prng_key(seeds, device="cpu") -> torch.Tensor:
    """`jax.random.PRNGKey` of each integer seed, as jax computes it with
    64-bit types off (its default): ``[0, seed & 0xFFFFFFFF]``.  So a
    seed keys by its low 32 bits, and an int32 sum that wrapped (the
    fleet's ``int32(seed) + 1``) keys as the unwrapped sum does.  `seeds`
    is an int or a sequence of ints; returns ``[2]`` or ``[len(seeds),
    2]``."""
    s = torch.as_tensor(seeds, dtype=torch.int64, device=device) & _MASK
    return torch.stack([torch.zeros_like(s), s], dim=-1)


def split(keys: torch.Tensor, n: int = 2) -> torch.Tensor:
    """`jax.random.split(key, n)` of each key: ``[..., 2] → [..., n, 2]``
    (counters: high word 0, low word the subkey's index)."""
    iota = torch.arange(n, dtype=torch.int64, device=keys.device)
    b1, b2 = threefry2x32(keys[..., 0:1], keys[..., 1:2], 0, iota)
    return torch.stack([b1, b2], dim=-1)


def fold_in(keys: torch.Tensor, data) -> torch.Tensor:
    """`jax.random.fold_in(key, data)`: the hash of the counter ``[0,
    data]`` under each key.  `data` (int or int tensor) broadcasts
    against the keys' leading axes."""
    d = torch.as_tensor(data, dtype=torch.int64, device=keys.device) & _MASK
    b1, b2 = threefry2x32(keys[..., 0], keys[..., 1], 0, d)
    return torch.stack([b1, b2], dim=-1)


def uniform(keys: torch.Tensor, n: int) -> torch.Tensor:
    """`jax.random.uniform(key, (n,))` (float32 in [0, 1)) of each key:
    ``[..., 2] → [..., n]``.  The 32 random bits of draw j are the xor of
    the hash's two words at the counter ``[0, j]``; their top 23 become
    the mantissa of a float in [1, 2), less 1."""
    iota = torch.arange(n, dtype=torch.int64, device=keys.device)
    b1, b2 = threefry2x32(keys[..., 0:1], keys[..., 1:2], 0, iota)
    bits = ((b1 ^ b2) >> 9) | _ONE_BITS
    floats = bits.to(torch.int32).view(torch.float32) - 1.0
    return torch.clamp(floats, min=0.0)
