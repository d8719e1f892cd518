"""Woodcock (delta) tracking free-flight sampling over a ray wavefront.

Port of cudavolumerenderer_tpu/ops/woodcock.py (reference:
Utilities.cuh:134-155, called from Medium.h:135-143): every iteration all
running lanes take one tentative step and one density gather; lanes that
accept an event or overrun the boundary drop out of the running mask.
RNG draws advance only on running lanes, so per-lane streams match a
sequential execution.  The world→[0,1]^3 transform is the exact box
normalization (p - box_min) / extent, as in the JAX package.

Port note: the lax.while_loop is a host loop that reads whether any lane
still runs once every `check_every` steps.  A step taken when no lane
runs changes nothing (every draw and update is masked), so the result
does not depend on `check_every`; the step count is kept on the device
and counts only steps on which some lane ran, as the JAX loop's does.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..constants import EPSILON
from .grid import Grid, sample, tap_voxels
from .rng import RngState, next_float

#: steps per host read of the running mask in woodcock_track
CHECK_EVERY = 4


class WoodcockResult(NamedTuple):
    t: torch.Tensor  # (...,) sampled free-flight distance (may exceed max_t)
    scattered: torch.Tensor  # (...,) bool — event before the boundary
    rng: RngState
    n_steps: torch.Tensor  # () int64 — tracking iterations with a running lane


def _inv_sigmat(density_scale, max_density, device):
    scale = torch.as_tensor(density_scale, dtype=torch.float32, device=device)
    rho_max = torch.as_tensor(max_density, dtype=torch.float32, device=device)
    return 1.0 / (scale * rho_max), scale


def woodcock_track(
    density: Grid,
    box_min: torch.Tensor,
    box_max: torch.Tensor,
    density_scale,
    max_density,
    o: torch.Tensor,  # (..., 3)
    d: torch.Tensor,  # (..., 3)
    max_t: torch.Tensor,  # (...,)
    rng: RngState,
    active: torch.Tensor,  # (...,) bool — lanes that should track at all
    interpolation: str = "trilinear",
    check_every: int = CHECK_EVERY,
    taps=None,
) -> WoodcockResult:
    """Sample free-flight distances for all active lanes.

    t += -log(max(u, EPS)) / (scale * rho_max); accept when
    rho(x)/rho_max >= u'; stop when t > max_t.  Inactive lanes return
    t = 0, scattered = False, untouched RNG.  A list given as `taps`
    receives ("density", the flat voxels) of each step's running lanes.
    """
    inv_sigmat, scale = _inv_sigmat(density_scale, max_density, o.device)
    extent = box_max - box_min

    t = torch.zeros(max_t.shape, dtype=torch.float32, device=o.device)
    n_steps = torch.zeros((), dtype=torch.int64, device=o.device)
    running = active
    while bool(torch.any(running)):
        for _ in range(check_every):
            n_steps = n_steps + torch.any(running)
            u1, rng = next_float(rng, running)
            step = -torch.log(torch.clamp(u1, min=EPSILON)) * inv_sigmat
            t_new = t + step
            p = o + t_new[..., None] * d
            p01 = (p - box_min) / extent
            rho = sample(density, p01, interpolation)
            if taps is not None:
                taps.append(("density", tap_voxels(density, p01,
                                                   interpolation)[running]))
            u2, rng = next_float(rng, running)
            keep = torch.logical_and(
                t_new <= max_t, scale * rho * inv_sigmat < u2
            )
            t = torch.where(running, t_new, t)
            running = torch.logical_and(running, keep)
    scattered = torch.logical_and(active, t < max_t)
    return WoodcockResult(t=t, scattered=scattered, rng=rng, n_steps=n_steps)


def woodcock_step_masked(
    density: Grid,
    box_min: torch.Tensor,
    box_max: torch.Tensor,
    density_scale,
    max_density,
    o: torch.Tensor,
    d: torch.Tensor,
    t: torch.Tensor,
    max_t: torch.Tensor,
    rng: RngState,
    tracking: torch.Tensor,  # (...,) bool — lanes currently mid-tracking
    interpolation: str = "trilinear",
    taps=None,
):
    """One fused tracking step for the wavefront schedulers (streaming,
    sorting, streamingMK).  Returns (t_new, terminated, scattered, rng):
    ``terminated`` lanes finished their segment this step; ``scattered``
    distinguishes a real medium event from a boundary overrun.  A list
    given as `taps` receives ("density", the stepping lanes' voxels)."""
    inv_sigmat, scale = _inv_sigmat(density_scale, max_density, o.device)
    extent = box_max - box_min

    u1, rng = next_float(rng, tracking)
    step = -torch.log(torch.clamp(u1, min=EPSILON)) * inv_sigmat
    t_new = torch.where(tracking, t + step, t)
    p = o + t_new[..., None] * d
    p01 = (p - box_min) / extent
    rho = sample(density, p01, interpolation)
    if taps is not None:
        taps.append(("density", tap_voxels(density, p01,
                                           interpolation)[tracking]))
    u2, rng = next_float(rng, tracking)

    overran = t_new > max_t
    accepted = torch.logical_not(scale * rho * inv_sigmat < u2)
    terminated = torch.logical_and(
        tracking, torch.logical_or(overran, accepted)
    )
    scattered = torch.logical_and(terminated, torch.logical_not(overran))
    return t_new, terminated, scattered, rng
