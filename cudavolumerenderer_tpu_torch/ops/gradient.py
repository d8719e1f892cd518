"""Density-gradient probes for shading normals and isosurface detection.

Port of cudavolumerenderer_tpu/ops/gradient.py (reference:
Gradient.h:9-39): central/forward finite differences of the density
field in normalized [0, 1] volume coordinates, intensity 0 outside the
unit cube.  The reference's sign convention is kept: gradient_cd returns
I(p - delta) - I(p + delta) per axis, i.e. MINUS the density gradient.
"""

from __future__ import annotations

import torch

from .grid import Grid, sample, tap_voxels

#: probe step in volume coordinates (reference: MIN_STEP, Gradient.h:4)
MIN_STEP = 0.1


def volume_intensity(grid: Grid, p01, interpolation: str = "trilinear"):
    """Density at normalized coords; 0 outside [0, 1]^3
    (reference: getVolumeIntensity, Gradient.h:10-13)."""
    inside = torch.all(torch.logical_and(p01 >= 0.0, p01 <= 1.0), dim=-1)
    v = sample(grid, torch.clamp(p01, 0.0, 1.0), interpolation)
    return torch.where(inside, v, 0.0)


def _delta(ax: int, min_step: float, device) -> torch.Tensor:
    delta = torch.zeros(3, dtype=torch.float32, device=device)
    delta[ax] = min_step
    return delta


def gradient_cd(
    grid: Grid, p01, min_step: float = MIN_STEP,
    interpolation: str = "trilinear",
):
    """Central-difference negative gradient (reference: gradientCD,
    Gradient.h:16-27).  Returns (..., 3)."""
    comps = []
    for ax in range(3):
        delta = _delta(ax, min_step, p01.device)
        hi = volume_intensity(grid, p01 + delta, interpolation)
        lo = volume_intensity(grid, p01 - delta, interpolation)
        comps.append(lo - hi)
    return torch.stack(comps, dim=-1)


def cd_voxels(
    grid: Grid, p01, min_step: float = MIN_STEP,
    interpolation: str = "trilinear",
):
    """The flat voxels gradient_cd reads at p01: (taps (..., 6, K), inside
    (..., 6)), per probe (+x, -x, +y, -y, +z, -z) its K voxels (8, or 1 for
    'nearest') and whether it lies in the unit cube (a probe outside reads
    none: its intensity is 0), for a bound's count of distinct voxels."""
    probes = []
    for ax in range(3):
        delta = _delta(ax, min_step, p01.device)
        probes += [p01 + delta, p01 - delta]
    q = torch.stack(probes, dim=-2)
    inside = torch.all(torch.logical_and(q >= 0.0, q <= 1.0), dim=-1)
    return tap_voxels(grid, torch.clamp(q, 0.0, 1.0), interpolation), inside


def gradient_fd(
    grid: Grid, p01, min_step: float = MIN_STEP,
    interpolation: str = "trilinear",
):
    """Forward-difference negative gradient (reference: gradientFD,
    Gradient.h:30-39)."""
    i0 = volume_intensity(grid, p01, interpolation)
    comps = []
    for ax in range(3):
        delta = _delta(ax, min_step, p01.device)
        comps.append(i0 - volume_intensity(grid, p01 + delta, interpolation))
    return torch.stack(comps, dim=-1)
