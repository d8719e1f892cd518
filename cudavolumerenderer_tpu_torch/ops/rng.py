"""Counter-free, lane-parallel PCG random number generator.

Port of cudavolumerenderer_tpu/ops/rng.py, bit-equal to it.  Each lane
carries a (state, inc) pair of 32-bit words; draws are pure functions
threading the state, and streams are seeded purely from (seed, path_id),
so an image does not depend on which lane or pool renders a path.

Generator: PCG-RXS-M-XS-32 with per-lane odd stream increments.

Words are held in int64 tensors masked to 32 bits: torch's uint32 dtype
has no CPU kernels for `+` or `>>`.  Products by a 32-bit constant are
split into 16-bit halves so no intermediate leaves the int64 range.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

M32 = 0xFFFFFFFF
_MULT = 747796405


class RngState(NamedTuple):
    """Per-lane RNG state; both fields share the lane batch shape."""

    state: torch.Tensor  # int64 holding a uint32
    inc: torch.Tensor  # int64 holding a uint32, always odd (stream selector)


def mul32(a: torch.Tensor, m: int) -> torch.Tensor:
    """(a * m) mod 2^32 for int64 tensors holding uint32 values."""
    lo, hi = m & 0xFFFF, m >> 16
    return (a * lo + (((a * hi) & 0xFFFF) << 16)) & M32


def as_u32(x, device=None) -> torch.Tensor:
    """Any integer tensor or Python int as an int64 tensor of uint32 words
    (negative values wrap, like JAX's astype(uint32))."""
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(x, dtype=torch.int64, device=device)
    return x.to(torch.int64) & M32


def hash32(x: torch.Tensor) -> torch.Tensor:
    """Low-bias 32-bit integer hash (triple32-style avalanche)."""
    x = as_u32(x)
    x = x ^ (x >> 16)
    x = mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = mul32(x, 0x846CA68B)
    x = x ^ (x >> 16)
    return x


def make_rng(seed, path_id: torch.Tensor) -> RngState:
    """Independent per-lane streams from (seed, path_id): the stream
    depends only on logical path identity, never on the lane."""
    pid = as_u32(path_id)
    seed_h = mul32(as_u32(seed, pid.device), 0x9E3779B9)
    state = hash32(pid ^ seed_h)
    inc = ((hash32((pid + 0x632BE5AB) & M32) << 1) & M32) | 1
    return RngState(state=state, inc=inc)


def _advance(rng: RngState) -> Tuple[torch.Tensor, RngState]:
    """One PCG step; returns 32 output bits and the new state."""
    s = (mul32(rng.state, _MULT) + rng.inc) & M32
    word = mul32((s >> ((s >> 28) + 4)) ^ s, 277803737)
    out = (word >> 22) ^ word
    return out, RngState(state=s, inc=rng.inc)


def next_uint32(rng: RngState, active=None) -> Tuple[torch.Tensor, RngState]:
    """Draw 32 random bits per lane.  Inactive lanes do not consume a
    draw (their state is left untouched)."""
    out, new_rng = _advance(rng)
    if active is not None:
        new_rng = RngState(
            state=torch.where(active, new_rng.state, rng.state), inc=rng.inc
        )
    return out, new_rng


def jump_constants(n: int) -> torch.Tensor:
    """PCG jump-ahead table, (2, n + 1) int64 of uint32 words: row 0 holds
    A_m = MULT^m and row 1 G_m = sum_{i<m} MULT^i (mod 2^32), so the state
    after m draws from (state, inc) is A_m * state + G_m * inc (mod 2^32).
    The tail kernel (csrc/tailpk.cu) reads it to start each lane of a
    round at its own draw."""
    a, g, rows = 1, 0, []
    for _ in range(n + 1):
        rows.append((a, g))
        a, g = (a * _MULT) & M32, (g * _MULT + 1) & M32
    return torch.tensor(rows, dtype=torch.int64).T.contiguous()


def next_float(rng: RngState, active=None) -> Tuple[torch.Tensor, RngState]:
    """Uniform float32 in [0, 1) with 24 bits of mantissa entropy."""
    bits, rng = next_uint32(rng, active)
    u = (bits >> 8).to(torch.float32) * (1.0 / (1 << 24))
    return u, rng


def next_float2(rng: RngState, active=None):
    """Two sequential uniforms (matches Rng::getFloat2 draw order)."""
    u1, rng = next_float(rng, active)
    u2, rng = next_float(rng, active)
    return u1, u2, rng
