"""The JAX package's random draws, reproduced in PyTorch.

The JAX package's RANSAC solvers draw their hypotheses with
`jax.random.categorical(PRNGKey(seed), where(valid, 0, -1e9), shape)`.
This module computes the same stream, so that the port's solvers see the
reference's hypotheses for the same seed, on any device.  It follows JAX
0.9.0 with `jax_threefry_partitionable` on (that release's default):

- a key is `threefry_seed(seed)`: the seed's high and low 32-bit words
  (`jax/_src/prng.py threefry_seed`);
- random bits come from threefry2x32 over counters that are the flat
  element index as a uint64 split into its high and low words
  (`prng.py iota_2x32_shape`); 32-bit draws take `b1 ^ b2`
  (`prng.py _threefry_random_bits_partitionable`);
- a uniform sets the mantissa bits of 1.0 and subtracts 1.0
  (`jax/_src/random.py _uniform`);
- a Gumbel draw is the "low" mode, `-log(-log(uniform(tiny, 1)))`
  (`random.py _gumbel`);
- a categorical draw is `argmax(gumbel + logits)` over the last axis,
  the first index winning a tie, as `jnp.argmax` does.

The 32-bit words live in int64 tensors masked with 0xFFFFFFFF, which
behave the same on the CPU and on CUDA.  Every draw is the f32 stream (32
bits an element), the one the JAX package's solvers draw with x64 off;
JAX draws f64 logits from a 64-bit stream, which the port never uses.
"""

from __future__ import annotations

import math

import torch

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
# The logit of an invalid row in the JAX solvers' draws.
INVALID_LOGIT = -1e9


def prng_key(seed: int) -> tuple[int, int]:
    """`jax.random.PRNGKey(seed)`'s two words: (seed >> 32, seed & MASK),
    so (0, seed) for a seed below 2**32."""
    seed = int(seed)
    if not 0 <= seed < 2 ** 64:
        raise ValueError(f"seed must lie in [0, 2**64), got {seed}")
    return (seed >> 32) & MASK, seed & MASK


# On the CPU the bits are computed in chunks that stay in the cache; on a
# GPU in one piece.
_CPU_CHUNK = 1 << 16


def threefry2x32(key, x0: torch.Tensor, x1: torch.Tensor):
    """threefry2x32 of the counter words (x0, x1) under key (k0, k1):
    20 rounds, a key injection after every four.  In place on fresh
    copies."""
    k0, k1 = key
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]).bitwise_and_(MASK)
    x1 = (x1 + ks[1]).bitwise_and_(MASK)
    tmp = torch.empty_like(x1)
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0.add_(x1).bitwise_and_(MASK)
            torch.bitwise_right_shift(x1, 32 - r, out=tmp)
            x1.bitwise_left_shift_(r).bitwise_or_(tmp).bitwise_and_(MASK)
            x1.bitwise_xor_(x0)
        x0.add_(ks[(i + 1) % 3]).bitwise_and_(MASK)
        x1.add_(ks[(i + 2) % 3] + i + 1).bitwise_and_(MASK)
    return x0, x1


def _bits_at(key, counters: torch.Tensor):
    """threefry2x32's two output words at the given flat indices."""
    flat = counters.reshape(-1)
    if flat.device.type != "cpu" or flat.numel() <= _CPU_CHUNK:
        b1, b2 = threefry2x32(key, flat >> 32, flat & MASK)
    else:
        b1, b2 = torch.empty_like(flat), torch.empty_like(flat)
        for s in range(0, flat.numel(), _CPU_CHUNK):
            c = flat[s:s + _CPU_CHUNK]
            b1[s:s + _CPU_CHUNK], b2[s:s + _CPU_CHUNK] = threefry2x32(
                key, c >> 32, c & MASK)
    return b1.reshape(counters.shape), b2.reshape(counters.shape)


def _counters(shape, device) -> torch.Tensor:
    return torch.arange(math.prod(shape), dtype=torch.int64,
                        device=device).reshape(shape)


def random_bits(key, shape, device=None) -> torch.Tensor:
    """`jax.random.bits(key, shape)` (uint32 values) as int64."""
    b1, b2 = _bits_at(key, _counters(tuple(shape), device))
    return b1 ^ b2


def _uniform_at(key, counters: torch.Tensor, minval, maxval):
    """The f32 uniform of the mantissa bits at the given counters,
    max(minval, unit * (maxval - minval) + minval) with the multiply-add
    fused as XLA fuses it (in f64 the product is exact)."""
    b1, b2 = _bits_at(key, counters)
    unit = ((b1 ^ b2) >> 9).to(torch.float32) * 2.0 ** -23
    lo = torch.tensor(minval, dtype=torch.float32, device=unit.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=unit.device)
    out = (unit.double() * (hi - lo).double() + lo.double()).float()
    return torch.maximum(lo, out)


def uniform(key, shape, minval=0.0, maxval=1.0, device=None) -> torch.Tensor:
    """`jax.random.uniform(key, shape, float32, minval, maxval)`."""
    return _uniform_at(key, _counters(tuple(shape), device), minval, maxval)


def _gumbel_at(key, counters: torch.Tensor) -> torch.Tensor:
    u = _uniform_at(key, counters, torch.finfo(torch.float32).tiny, 1.0)
    return -torch.log(-torch.log(u))


def gumbel(key, shape, device=None) -> torch.Tensor:
    """`jax.random.gumbel(key, shape, float32, mode="low")`."""
    return _gumbel_at(key, _counters(tuple(shape), device))


def categorical(key, logits: torch.Tensor, shape) -> torch.Tensor:
    """`jax.random.categorical(key, logits, shape=shape)` over f32 logits
    (axis -1, with replacement): int64 indices of the given shape, on
    logits' device."""
    shape = tuple(shape)
    n = logits.shape[-1]
    g = gumbel(key, (*shape, n), logits.device)
    return torch.argmax(g + logits.float(), dim=-1)


def categorical_valid(key, valid: torch.Tensor, shape) -> torch.Tensor:
    """`categorical(key, where(valid, 0, -1e9), shape)` for a 1-D mask,
    computing the bits of the valid columns only.

    A valid logit's Gumbel sum lies above -7 and an invalid one at -1e9
    or below, so the draw is the first maximum of the Gumbel values over
    the valid columns, whose counters are (flat sample index) * N +
    column.  With no valid row, f32 rounds every -1e9 + g to -1e9 and the
    first index, 0, wins everywhere."""
    shape = tuple(shape)
    n = valid.shape[0]
    cols = torch.nonzero(valid).flatten()
    if cols.numel() == 0:
        return torch.zeros(shape, dtype=torch.int64, device=valid.device)
    samples = _counters(shape, valid.device)
    g = _gumbel_at(key, samples[..., None] * n + cols)
    return cols[torch.argmax(g, dim=-1)]
