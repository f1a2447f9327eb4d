"""Frozen copy of the port's threefry draws (jax.random's bits, in torch).

The reference draws the same random numbers as the simulator from the same
keys, so its selections (graft and prune picks, send orders, gossip
targets, churn, mix paths) are the model's and not a sample of their
distribution. Kept here so that no later change to the program can move
the yardstick.

Every random choice of the reference engine is a threefry2x32 draw in jax's
partitionable mode (`jax_threefry_partitionable=True`, the default of the
jax release the reference pins). Reproducing those bits is what lets the
port be held leaf by leaf against the reference: same seed, same mesh, same
send orders, same arrival times.

A key is a (2,) int64 tensor holding two uint32 words. All uint32
arithmetic runs in int64 with `& 0xFFFFFFFF`, which gives the same bits on
the CPU and on CUDA without relying on unsigned tensor support.

  PRNGKey(seed)        -> [seed >> 32 (0 for 32-bit seeds), seed & MASK]
  split(key, num)      -> (num, 2): threefry(key, counts = (0, i))
  uniform(key, shape)  -> f32 in [0, 1): bits = hi ^ lo of
                          threefry(key, counts = (idx >> 32, idx & MASK)),
                          then (bits >> 9) | 0x3F800000 viewed as f32, minus 1

Element idx's bits depend on its flat index alone, so a row block of a
draw is a draw of its own counters: `rows=(r0, r1)` on `random_bits`,
`uniform` and `randint` gives rows [r0, r1) of axis `axis` of the full
`shape` draw, bit for bit, without drawing the other rows (a rank of the
peer mesh draws its rows this way, parallel/peer.py).
"""

from __future__ import annotations

import torch

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(x: torch.Tensor, d: int) -> torch.Tensor:
    return ((x << d) | (x >> (32 - d))) & MASK


def threefry2x32(k1, k2, x0: torch.Tensor, x1: torch.Tensor):
    """The 20-round threefry2x32 hash of the counter pair (x0, x1) under
    key (k1, k2); every value is a uint32 held in int64."""
    k3 = k1 ^ k2 ^ _PARITY
    ks = (k1, k2, k3)
    x0 = (x0 + k1) & MASK
    x1 = (x1 + k2) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK
    return x0, x1


def PRNGKey(seed: int, device="cpu") -> torch.Tensor:
    """jax.random.PRNGKey(seed) for the 32-bit seeds the simulator uses."""
    seed = int(seed)
    hi = (seed >> 32) & MASK if not -2**31 <= seed < 2**31 else 0
    return torch.tensor([hi, seed & MASK], dtype=torch.int64, device=device)


def _counts(numel: int, device):
    idx = torch.arange(numel, dtype=torch.int64, device=device)
    return idx >> 32, idx & MASK


def _block_counts(shape: tuple, rows, axis: int, device):
    """Flat indices into a row-major `shape` of rows [r0, r1) of `axis`
    (every index of the other axes), in the block's own row-major order;
    returns (hi, lo, block shape)."""
    r0, r1 = rows
    if not 0 <= r0 <= r1 <= shape[axis]:
        raise ValueError(f"rows {rows} outside axis {axis} of {shape}")
    block = shape[:axis] + (r1 - r0,) + shape[axis + 1:]
    idx = torch.zeros(block, dtype=torch.int64, device=device)
    stride = 1
    for d in range(len(shape) - 1, -1, -1):
        ar = torch.arange(block[d], dtype=torch.int64, device=device)
        if d == axis:
            ar = ar + r0
        view = [1] * len(shape)
        view[d] = block[d]
        idx = idx + (ar * stride).view(view)
        stride *= shape[d]
    idx = idx.reshape(-1)
    return idx >> 32, idx & MASK, block


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """jax.random.split: (num, 2) new keys."""
    hi, lo = _counts(num, key.device)
    b0, b1 = threefry2x32(key[0], key[1], hi, lo)
    return torch.stack([b0, b1], dim=1)


def random_bits(key: torch.Tensor, shape, rows=None,
                axis: int = 0) -> torch.Tensor:
    """32 random bits per element (as int64), jax's partitionable layout;
    with `rows=(r0, r1)` only rows [r0, r1) of `axis` of that draw."""
    shape = tuple(shape)
    if rows is None:
        numel = 1
        for d in shape:
            numel *= d
        hi, lo = _counts(numel, key.device)
        block = shape
    else:
        hi, lo, block = _block_counts(shape, tuple(rows), axis, key.device)
    b0, b1 = threefry2x32(key[0], key[1], hi, lo)
    return (b0 ^ b1).reshape(block)


def uniform(key: torch.Tensor, shape, rows=None,
            axis: int = 0) -> torch.Tensor:
    """jax.random.uniform(key, shape) in float32 on [0, 1) (`rows`: a row
    block of it, as random_bits)."""
    bits = random_bits(key, shape, rows, axis)
    mant = ((bits >> 9) | 0x3F800000).to(torch.int32)
    return mant.view(torch.float32) - 1.0


def randint(key: torch.Tensor, shape, minval: int, maxval: int, rows=None,
            axis: int = 0):
    """jax.random.randint(key, shape, minval, maxval, dtype=int32) for
    0 <= minval < maxval < 2^31, as int32: two 32-bit draws folded into
    [0, span) by jax's multiplier rule, in uint32 arithmetic (`rows`: a
    row block of it, as random_bits)."""
    span = max(int(maxval) - int(minval), 1)
    k1, k2 = split(key)
    hi = random_bits(k1, shape, rows, axis)
    lo = random_bits(k2, shape, rows, axis)
    mult = (2 ** 16) % span
    mult = ((mult * mult) & MASK) % span
    off = (((hi % span) * mult) & MASK) + (lo % span)
    off = (off & MASK) % span
    return (int(minval) + off).to(torch.int32)
