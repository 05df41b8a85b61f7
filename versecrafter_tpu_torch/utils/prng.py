"""JAX's threefry2x32 PRNG in torch: the same seed gives the same draws.

The JAX package draws its initial latents with
``jax.random.normal(jax.random.key(seed), shape, dtype)`` and its training
noise with ``split`` -> ``uniform`` / ``normal``. This module repeats those
functions (``jax_threefry_partitionable`` on, the JAX default) on any torch
device, so that a request or a train step with a given seed sees the same
noise in both packages:

- ``key(seed)``: a key is an int64 tensor [2] holding the two uint32 words
  (seed >> 32, seed & 0xFFFFFFFF) on the caller's device;
- ``split(key, num)``: threefry2x32 of the 64-bit counter 0 .. num - 1
  (high and low words), the two output words of counter i being key i;
- ``random_bits``: threefry2x32 over the counter of every element, the two
  output words XORed (32 bits) or its low byte (8 bits);
- ``uniform``: the top mantissa bits under the exponent of 1.0, minus 1,
  scaled into [minval, maxval) in the target dtype (bf16 takes 8 random
  bits, as JAX does for a mantissa narrower than 8 bits; in fp32 the scale
  and shift are one fused multiply-add, as XLA compiles them);
- ``normal``: sqrt(2) * erfinv(uniform(nextafter(-1, 0), 1)). In bf16 the
  erfinv is taken in fp32 and rounded to bf16, then multiplied by
  bf16(sqrt 2) and rounded again: bit-identical to JAX on the CPU. In fp32
  torch's erfinv differs from XLA's by a few ulp.

Words are uint32 values held in int64 tensors and masked to 32 bits after
every add and shift, so it runs as plain integer tensor ops on the CPU or
the card with no host round trip.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def key(seed: int, device=None) -> torch.Tensor:
    """The key of an integer seed (``jax.random.key(seed)``), on `device`."""
    seed = int(seed)
    # JAX without x64 holds a seed in int32: its high word is then 0
    hi = (seed >> 32) & _M32 if not -2**31 <= seed < 2**31 else 0
    return torch.tensor([hi, seed & _M32], dtype=torch.int64, device=device)


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & _M32) | (x >> (32 - r))


def threefry2x32(k: torch.Tensor, x0: torch.Tensor, x1: torch.Tensor):
    """The Threefry-2x32 hash (20 rounds) of the counter words (x0, x1)
    under key k = (k0, k1); every word a uint32 in an int64 tensor."""
    k0, k1 = k[0], k[1]
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x0, x1


def _hash_iota(k: torch.Tensor, shape: Sequence[int]):
    """threefry2x32 of the 64-bit row-major element index of `shape`."""
    n = math.prod(shape)
    idx = torch.arange(n, dtype=torch.int64, device=k.device)
    b0, b1 = threefry2x32(k, idx >> 32, idx & _M32)
    return b0.reshape(shape), b1.reshape(shape)


def split(k: torch.Tensor, num: int = 2) -> torch.Tensor:
    """`num` new keys [num, 2] (``jax.random.split``)."""
    b0, b1 = _hash_iota(k, (num,))
    return torch.stack([b0, b1], dim=1)


def random_bits(k: torch.Tensor, bit_width: int, shape: Sequence[int]) -> torch.Tensor:
    """Uniform random bits (8 or 32 wide) of `shape`, as int64."""
    b0, b1 = _hash_iota(k, tuple(shape))
    bits = b0 ^ b1
    if bit_width == 32:
        return bits
    if bit_width == 8:
        return bits & 0xFF
    raise ValueError(f"bit_width {bit_width}: only 8 and 32 are ported")


def _bits_to_unit(bits: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Random mantissa bits under the exponent of 1.0, minus 1: [0, 1)."""
    if dtype == torch.float32:
        f = (bits >> 9) | 0x3F800000
        return f.to(torch.int32).view(torch.float32) - 1.0
    if dtype == torch.bfloat16:
        f = (bits >> 1) | 0x3F80  # 8 random bits -> 7 mantissa bits
        return f.to(torch.int16).view(torch.bfloat16) - 1.0
    raise ValueError(f"dtype {dtype}: only float32 and bfloat16 are ported")


def uniform(k: torch.Tensor, shape: Sequence[int], dtype=torch.float32,
            minval: float = 0.0, maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform``: values in [minval, maxval), every operation
    rounded to `dtype` as JAX does it."""
    shape = tuple(int(s) for s in shape)
    bits = random_bits(k, 32 if dtype == torch.float32 else 8, shape)
    floats = _bits_to_unit(bits, dtype)
    lo = torch.tensor(minval, dtype=dtype, device=k.device)
    hi = torch.tensor(maxval, dtype=dtype, device=k.device)
    if dtype == torch.float32:  # XLA contracts floats * range + lo into an FMA
        return torch.maximum(lo, _fma32(floats, hi - lo, lo))
    return torch.maximum(lo, floats * (hi - lo) + lo)


def _fma32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """fp32 a * b + c rounded once, as a fused multiply-add: the product is
    exact in fp64, the sum is rounded to odd in fp64 (TwoSum gives its
    rounding error), and rounding that to fp32 is then the single rounding
    (53 >= 2 * 24 + 2 bits)."""
    p = a.double() * b.double()
    c = c.double().expand_as(p)
    s = p + c
    bc = s - p
    err = (p - (s - bc)) + (c - bc)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, math.inf, -math.inf).to(s.dtype)
    return torch.where((err != 0) & even, torch.nextafter(s, toward), s).float()


# nextafter(-1, 0) in each dtype: the lower end of normal's uniform draw
_LO = {torch.float32: float(np.nextafter(np.float32(-1.0), np.float32(0.0))),
       torch.bfloat16: -(1.0 - 2.0 ** -8)}


def normal(k: torch.Tensor, shape: Sequence[int], dtype=torch.float32) -> torch.Tensor:
    """``jax.random.normal``: sqrt(2) * erfinv(u), u uniform in (-1, 1)."""
    if dtype not in _LO:
        raise ValueError(f"dtype {dtype}: only float32 and bfloat16 are ported")
    u = uniform(k, shape, dtype, _LO[dtype], 1.0)
    e = torch.erfinv(u.float()).to(dtype)
    sqrt2 = torch.tensor(math.sqrt(2.0), dtype=dtype, device=k.device)
    return sqrt2 * e
