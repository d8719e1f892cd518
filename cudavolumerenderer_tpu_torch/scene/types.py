"""Scene data model consumed by the render functions.

Port of cudavolumerenderer_tpu/scene/types.py (reference: Scene.h:19-54,
Medium.h:111-191, Bsdf.h:17-30).  `Medium`, `Bsdf` and `Scene` are
`nn.Module`s that hold their grids and parameters as buffers, so
`scene.to(device)` moves the whole scene; `RenderSettings` is the frozen
dataclass of static rendering switches.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..ops.grid import Grid


class Medium(nn.Module):
    """Heterogeneous participating medium (reference: Medium.h:111-158).

    albedo_affine is the (2, 3) [A; B] with albedo == A * density + B
    voxelwise (detected at build time), else None: the fastSK fused table
    then stays a flat density-only vector.  The fit belongs to the
    build-time density; `with_density` clears it."""

    def __init__(
        self, density: Grid, albedo: Grid, box_min, box_max, scale,
        max_density, g, albedo_affine: Optional[torch.Tensor] = None,
    ):
        super().__init__()
        self.density = density  # (Z, Y, X) float32
        self.albedo = albedo  # (Z, Y, X, 4) float32
        self.register_buffer("box_min", box_min)  # (3,)
        self.register_buffer("box_max", box_max)  # (3,)
        self.register_buffer("scale", scale)  # () sigma_t multiplier
        self.register_buffer("max_density", max_density)  # ()
        self.register_buffer("g", g)  # () HG anisotropy
        self.register_buffer("albedo_affine", albedo_affine)

    def with_density(self, density_zyx: torch.Tensor) -> "Medium":
        """Replace the density grid, clearing the build-time affine fit."""
        return Medium(
            Grid(density_zyx), self.albedo, self.box_min, self.box_max,
            self.scale, self.max_density, self.g, albedo_affine=None,
        )


class Bsdf(nn.Module):
    """Rough-dielectric boundary (reference: Bsdf.h:17-30);
    eta = int_ior / ext_ior (reference default 1.05 / 1.01)."""

    def __init__(self, roughness: torch.Tensor, eta: torch.Tensor):
        super().__init__()
        self.register_buffer("roughness", roughness)  # (2,)
        self.register_buffer("eta", eta)  # ()


class Scene(nn.Module):
    """Medium + boundary + environment emission (the reference's only
    light is a constant white environment, Medium.h:174-177)."""

    def __init__(self, medium: Medium, bsdf: Bsdf, le: torch.Tensor):
        super().__init__()
        self.medium = medium
        self.bsdf = bsdf
        self.register_buffer("le", le)  # (3,) environment radiance

    @property
    def device(self) -> torch.device:
        return self.le.device


@dataclasses.dataclass(frozen=True)
class RenderSettings:
    """Static rendering switches (reference: Defines.h's compile-time
    knobs MITSUBA_COMPARABLE, RUSSIAN_ROULETTE, max_path_length, filter
    mode).  Fields, meanings and defaults as in the JAX package."""

    mitsuba_comparable: bool = True
    russian_roulette: bool = True
    max_path_length: int = 1000
    #: 'ggx' — reference boundary BSDF; 'null' — pass-through boundary
    #: (reference: Bsdf.h:6-15), used for white-furnace oracles.
    bsdf_kind: str = "ggx"
    #: grid filter of the integrator-family schedulers: 'trilinear' under
    #: mitsuba-comparable, else 'nearest' (reference: Volume.h:50-69);
    #: fastSK, fastQ and brickSK tap stochastically and do not read it
    interpolation: str = "trilinear"
    #: count traced rays (reference: RAYS_STATISTICS, Defines.h:49-50)
    rays_statistics: bool = True
    #: medium boundary model: 'aabb' (the box faces) or 'variable' (the
    #: density-isosurface march of the integrator-family schedulers;
    #: fastSK/fastQ/brickSK refuse it, models/renderer.make_kernel_fn)
    boundary: str = "aabb"
    #: gradient-magnitude threshold for the variable boundary
    boundary_threshold: float = 1e-8
    #: expected march step of the variable boundary, world units
    #: (reference: MIN_STEP uniform step scale, Medium.h:87)
    boundary_min_step: float = 0.1

    @classmethod
    def from_flags(cls, mitsuba_comparable: bool = True, **kw) -> "RenderSettings":
        interp = "trilinear" if mitsuba_comparable else "nearest"
        return cls(
            mitsuba_comparable=mitsuba_comparable, interpolation=interp, **kw
        )


def _f32(x, device) -> torch.Tensor:
    return torch.tensor(np.asarray(x, np.float32), device=device)


def loader_device(device) -> torch.device:
    """The device a scene loader or a scene/camera constructor builds on.
    They default to "cuda"; without a card that raises (there is no
    fallback) and a CPU caller passes device="cpu"."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device} needs a CUDA card and "
            "torch.cuda.is_available() is False; pass device=\"cpu\" to "
            "build the scene or camera on the CPU"
        )
    return device


def make_medium(
    density_zyx,
    albedo_zyx,
    box_min=(-0.5, -0.5, -0.5),
    box_max=(0.5, 0.5, 0.5),
    scale: float = 1.0,
    max_density: float | None = None,
    g: float = 0.0,
    device="cuda",
) -> Medium:
    """Assemble a Medium from volumes in x-fastest (Z, Y, X[,C]) layout.

    A scalar or (3,) albedo becomes a constant (1, 1, 1, 4) grid.  The
    affine albedo fit runs on numpy inputs; torch tensors pass through
    without a host round-trip and without a fit.  Builds on the card
    unless the caller passes device="cpu"."""
    device = loader_device(device)
    if not isinstance(density_zyx, torch.Tensor):
        density_zyx = np.asarray(density_zyx, np.float32)
    if np.ndim(albedo_zyx) <= 1:  # constant albedo
        albedo_zyx = np.broadcast_to(
            np.asarray(albedo_zyx, np.float32).reshape(1, 1, 1, -1),
            (1, 1, 1, 3),
        ).copy()
    if not isinstance(albedo_zyx, torch.Tensor):
        albedo_zyx = np.asarray(albedo_zyx, np.float32)
    if albedo_zyx.ndim == 3:
        albedo_zyx = albedo_zyx[..., None]
    if albedo_zyx.shape[-1] == 3:
        if isinstance(albedo_zyx, torch.Tensor):
            ones = torch.ones(
                albedo_zyx.shape[:-1] + (1,), dtype=torch.float32,
                device=albedo_zyx.device,
            )
            albedo_zyx = torch.cat([albedo_zyx, ones], dim=-1)
        else:
            albedo_zyx = np.concatenate(
                [albedo_zyx, np.ones(albedo_zyx.shape[:-1] + (1,), np.float32)],
                axis=-1,
            )
    if max_density is None:
        max_density = float(density_zyx.max())
    affine = None
    if (
        isinstance(density_zyx, np.ndarray)
        and isinstance(albedo_zyx, np.ndarray)
        and albedo_zyx.shape[:3] == density_zyx.shape
    ):
        affine = _fit_albedo_affine(density_zyx, albedo_zyx)
    return Medium(
        density=Grid(torch.as_tensor(density_zyx).to(device)),
        albedo=Grid(torch.as_tensor(albedo_zyx).to(device)),
        box_min=_f32(box_min, device),
        box_max=_f32(box_max, device),
        scale=_f32(scale, device),
        max_density=_f32(max_density, device),
        g=_f32(g, device),
        albedo_affine=None if affine is None else _f32(affine, device),
    )


def _fit_albedo_affine(
    density: np.ndarray, albedo: np.ndarray
) -> Optional[np.ndarray]:
    """Return (2, 3) [A; B] with albedo.rgb == A*density + B (exactly,
    within float32 rounding) or None.  Host-side, build-time only."""
    d = density.reshape(-1).astype(np.float32)
    a = albedo[..., :3].reshape(-1, 3).astype(np.float32)
    i_min, i_max = int(d.argmin()), int(d.argmax())
    d0, d1 = float(d[i_min]), float(d[i_max])
    if d1 - d0 < 1e-12:
        return None
    A = (a[i_max] - a[i_min]) / np.float32(d1 - d0)
    B = a[i_min] - A * np.float32(d0)
    # validate in slabs with early exit: no full-grid (N, 3) temporary
    chunk = 1 << 24
    for lo in range(0, d.shape[0], chunk):
        hi = min(lo + chunk, d.shape[0])
        if not np.allclose(
            a[lo:hi], d[lo:hi, None] * A + B, atol=2e-6, rtol=0.0
        ):
            return None
    return np.stack([A, B]).astype(np.float32)


def make_scene(
    medium: Medium,
    roughness: Tuple[float, float] = (0.1, 0.1),
    int_ior: float = 1.05,
    ext_ior: float = 1.01,
    le=(1.0, 1.0, 1.0),
) -> Scene:
    """Scene with the reference's default boundary and environment
    (reference: Bsdf.h:20-23, Medium.h:174-177)."""
    device = medium.box_min.device
    return Scene(
        medium=medium,
        bsdf=Bsdf(
            roughness=_f32(roughness, device),
            eta=_f32(int_ior / ext_ior, device),
        ),
        le=_f32(le, device),
    )
