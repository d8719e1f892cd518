"""Morton (Z-order) codes for spatial ray reordering.

Port of cudavolumerenderer_tpu/ops/morton.py (reference: Utilities.h:35-70,
MortonSort.h:12-68), bit-equal to it.  The sorting scheduler keys each
lane by the Morton code of its position in the medium box; dead lanes
sort to the end via the max key (MortonSort.h:39-44).

Codes are int64 tensors holding uint32 values (as in ops/rng.py): the
uint32 products of the JAX package wrap, so every product is masked to
32 bits, and DEAD_KEY = 0xFFFFFFFF sorts after every 30-bit code.
"""

from __future__ import annotations

import torch

from .rng import M32

DEAD_KEY = 0xFFFFFFFF


def expand_bits(v: torch.Tensor) -> torch.Tensor:
    """Spread the low 10 bits of v so they occupy every 3rd bit."""
    v = v.to(torch.int64) & M32
    v = ((v * 0x00010001) & M32) & 0xFF0000FF
    v = ((v * 0x00000101) & M32) & 0x0F00F00F
    v = ((v * 0x00000011) & M32) & 0xC30C30C3
    v = ((v * 0x00000005) & M32) & 0x49249249
    return v


def morton3d(p01: torch.Tensor) -> torch.Tensor:
    """30-bit Morton code of points in [0,1]^3 (shape (..., 3) → (...,))."""
    q = torch.clamp(p01 * 1024.0, 0.0, 1023.0).to(torch.int64)
    x = expand_bits(q[..., 0])
    y = expand_bits(q[..., 1])
    z = expand_bits(q[..., 2])
    return (x * 4 + y * 2 + z) & M32


def ray_sort_keys(
    p_world: torch.Tensor, box_min: torch.Tensor, box_max: torch.Tensor,
    alive: torch.Tensor,
) -> torch.Tensor:
    """Sort key per lane: Morton code of the normalized position for live
    lanes, the max key for dead lanes."""
    p01 = (p_world - box_min) / (box_max - box_min)
    return torch.where(alive, morton3d(p01), DEAD_KEY)
