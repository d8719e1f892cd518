"""Dense voxel-grid container and batched samplers.

Port of cudavolumerenderer_tpu/ops/grid.py (reference: Volume.h:32-114,
CudaVolPath.cpp:118-186): a (Z, Y, X[,C]) float32 grid, x-fastest like
the reference's linear arrays, held by a module as a buffer so
`.to(device)` moves it with the scene.  Sampling is an 8-tap gather from
the flat grid; out-of-range taps clamp (cudaAddressModeClamp).

Interpolation modes mirror the reference's MITSUBA_COMPARABLE switch:
  - 'trilinear': manual 8-tap lerp (Volume.h:50-65), same order of
    multiplies and adds as the JAX package;
  - 'nearest'  : truncating-int point fetch (Volume.h:67 int() casts).
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

# Voxel coordinates are clamped to this magnitude before the integer
# cast, so an infinite coordinate saturates (as XLA's float->int does)
# instead of wrapping.
_COORD_LIMIT = float(1 << 62)


class Grid(nn.Module):
    """data: (Z, Y, X) for scalar fields or (Z, Y, X, C) for vector fields."""

    def __init__(self, data: torch.Tensor):
        super().__init__()
        self.register_buffer("data", data)

    @property
    def resolution(self) -> Tuple[int, int, int]:
        """(nx, ny, nz) — matches the reference's uint3 grid_resolution."""
        z, y, x = self.data.shape[:3]
        return (x, y, z)

    @property
    def channels(self) -> int:
        return 1 if self.data.ndim == 3 else self.data.shape[3]


def volume_to_grid(grid_shape_zyx, p01: torch.Tensor) -> torch.Tensor:
    """[0,1]^3 normalized coords → voxel coords, scaled by (res - 1)
    (reference: Volume.h:40-45 volumeToGrid)."""
    nz, ny, nx = grid_shape_zyx[:3]
    scale = torch.tensor(
        [nx - 1, ny - 1, nz - 1], dtype=torch.float32, device=p01.device
    )
    return p01 * scale


def _to_index(coord: torch.Tensor) -> torch.Tensor:
    """Truncate toward zero, as int() does, saturating out-of-range values."""
    return torch.clamp(coord, -_COORD_LIMIT, _COORD_LIMIT).to(torch.int64)


def _flat_gather(data: torch.Tensor, ix, iy, iz):
    """Clamped integer-tap gather from a (Z, Y, X[,C]) grid."""
    nz, ny, nx = data.shape[:3]
    ix = torch.clamp(ix, 0, nx - 1)
    iy = torch.clamp(iy, 0, ny - 1)
    iz = torch.clamp(iz, 0, nz - 1)
    flat_idx = (iz * ny + iy) * nx + ix
    if data.ndim == 3:
        return data.reshape(-1)[flat_idx]
    return data.reshape(-1, data.shape[3])[flat_idx]


def sample_nearest(grid: Grid, p01: torch.Tensor) -> torch.Tensor:
    """Point sampling with int() truncation semantics (Volume.h:67)."""
    idx = _to_index(volume_to_grid(grid.data.shape, p01))
    return _flat_gather(grid.data, idx[..., 0], idx[..., 1], idx[..., 2])


def sample_trilinear(grid: Grid, p01: torch.Tensor) -> torch.Tensor:
    """Manual 8-tap trilinear interpolation (Volume.h:50-65).

    Returns shape (...,) for scalar grids, (..., C) for vector grids.
    """
    coord = volume_to_grid(grid.data.shape, p01)
    c0 = torch.floor(coord)
    i0 = _to_index(c0)
    f = coord - c0
    x1, y1, z1 = i0[..., 0], i0[..., 1], i0[..., 2]
    fx, fy, fz = f[..., 0], f[..., 1], f[..., 2]

    if grid.data.ndim == 4:
        fx = fx[..., None]
        fy = fy[..., None]
        fz = fz[..., None]

    d000 = _flat_gather(grid.data, x1, y1, z1)
    d001 = _flat_gather(grid.data, x1 + 1, y1, z1)
    d010 = _flat_gather(grid.data, x1, y1 + 1, z1)
    d011 = _flat_gather(grid.data, x1 + 1, y1 + 1, z1)
    d100 = _flat_gather(grid.data, x1, y1, z1 + 1)
    d101 = _flat_gather(grid.data, x1 + 1, y1, z1 + 1)
    d110 = _flat_gather(grid.data, x1, y1 + 1, z1 + 1)
    d111 = _flat_gather(grid.data, x1 + 1, y1 + 1, z1 + 1)

    _fx, _fy, _fz = 1.0 - fx, 1.0 - fy, 1.0 - fz
    return (
        ((d000 * _fx + d001 * fx) * _fy + (d010 * _fx + d011 * fx) * fy) * _fz
        + ((d100 * _fx + d101 * fx) * _fy + (d110 * _fx + d111 * fx) * fy) * fz
    )


def tap_voxels(grid: Grid, p01: torch.Tensor,
               interpolation: str = "trilinear") -> torch.Tensor:
    """The flat voxel indices `sample` reads at p01: (..., 8) for
    'trilinear', (..., 1) for 'nearest' (a bound's count of the distinct
    voxels a kernel must read)."""
    nz, ny, nx = grid.data.shape[:3]
    coord = volume_to_grid(grid.data.shape, p01)
    if interpolation == "nearest":
        i0, offsets = _to_index(coord), ((0, 0, 0),)
    else:
        i0 = _to_index(torch.floor(coord))
        offsets = [(dx, dy, dz) for dz in (0, 1) for dy in (0, 1)
                   for dx in (0, 1)]
    taps = []
    for dx, dy, dz in offsets:
        ix = torch.clamp(i0[..., 0] + dx, 0, nx - 1)
        iy = torch.clamp(i0[..., 1] + dy, 0, ny - 1)
        iz = torch.clamp(i0[..., 2] + dz, 0, nz - 1)
        taps.append((iz * ny + iy) * nx + ix)
    return torch.stack(taps, dim=-1)


def sample(grid: Grid, p01: torch.Tensor, interpolation: str = "trilinear"):
    if interpolation == "trilinear":
        return sample_trilinear(grid, p01)
    if interpolation == "nearest":
        return sample_nearest(grid, p01)
    raise ValueError(f"unknown interpolation {interpolation!r}")
