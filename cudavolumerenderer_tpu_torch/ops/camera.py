"""Pinhole camera: pose, inverse-view matrix, and batched ray generation.

Port of cudavolumerenderer_tpu/ops/camera.py (reference: Camera.h:16-125,
CudaVolPath.cpp:67-85, Utilities.cuh:180-213).  The camera is a small
tuple of tensors; ray generation is one broadcasting program over all
pixels of a tile, jittered by the lane-parallel PCG streams.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..scene.types import loader_device
from . import math3
from .rng import RngState, next_float2


class Camera(NamedTuple):
    """inv_view is the 3x4 view-to-world matrix: rows transform a
    view-space direction; the 4th column is the world-space position
    (the constant the reference uploads, CudaVolPath.cpp:67-85)."""

    inv_view: torch.Tensor  # (3, 4) float32
    raster_to_view: torch.Tensor  # (2,) = tan(fov_{x,y} * pi / 360)

    def to(self, device) -> "Camera":
        return Camera(
            inv_view=self.inv_view.to(device),
            raster_to_view=self.raster_to_view.to(device),
        )


def _fov_r2v(res_x, res_y, fov_x_deg) -> np.ndarray:
    fov_y_deg = (float(res_y) / float(res_x)) * fov_x_deg
    return np.array(
        [
            math.tan(fov_x_deg * math.pi / 360.0),
            math.tan(fov_y_deg * math.pi / 360.0),
        ],
        dtype=np.float32,
    )


def make_camera(
    res_x: int = 400,
    res_y: int = 400,
    fov_x_deg: float = 0.7,
    position=(0.0, 0.0, 100.0),
    mitsuba_comparable: bool = True,
    device="cuda",
) -> Camera:
    """Default camera at +z looking down -z (reference: Camera.h:26-42);
    fov_y follows fov_x by aspect ratio, the x-axis handedness flip
    follows MITSUBA_COMPARABLE (Camera.h:30-34).  Builds on the card
    unless the caller passes device="cpu"."""
    device = loader_device(device)
    right_x = 1.0 if mitsuba_comparable else -1.0
    inv_view = np.array(
        [
            [right_x, 0.0, 0.0, position[0]],
            [0.0, -1.0, 0.0, position[1]],
            [0.0, 0.0, -1.0, position[2]],
        ],
        dtype=np.float32,
    )
    return Camera(
        inv_view=torch.tensor(inv_view, device=device),
        raster_to_view=torch.tensor(
            _fov_r2v(res_x, res_y, fov_x_deg), device=device
        ),
    )


def make_camera_look_at(
    eye, center, up, res_x: int, res_y: int, fov_x_deg: float,
    device="cuda",
) -> Camera:
    """Look-at constructor (reference: Camera.h lookAt:107-122).
    View-to-world columns are (right, -new_up, forward, eye).  Builds on
    the card unless the caller passes device="cpu"."""
    device = loader_device(device)
    eye = np.asarray(eye, np.float32)
    forward = np.asarray(center, np.float32) - eye
    forward = forward / np.linalg.norm(forward)
    right = np.cross(forward, np.asarray(up, np.float32))
    right = right / np.linalg.norm(right)
    new_up = np.cross(right, forward)
    new_up = new_up / np.linalg.norm(new_up)
    inv_view = np.stack(
        [right, -new_up, forward, eye], axis=1
    ).astype(np.float32)
    return Camera(
        inv_view=torch.tensor(inv_view, device=device),
        raster_to_view=torch.tensor(
            _fov_r2v(res_x, res_y, fov_x_deg), device=device
        ),
    )


def generate_rays(
    camera: Camera,
    pixel_xy: torch.Tensor,  # (..., 2) float32 pixel coordinates
    full_resolution: Tuple[int, int],
    rng: RngState,
    active=None,
) -> Tuple[torch.Tensor, torch.Tensor, RngState]:
    """Jittered camera rays for a batch of pixel coordinates
    (reference: indexToCameraRay, Utilities.cuh:208-213).

    The rotation is written as explicit multiply-adds, not a matmul, so
    no TF32 path can touch it on the card."""
    u1, u2, rng = next_float2(rng, active)
    rx = ((pixel_xy[..., 0] + u1) * 2.0 / float(full_resolution[0])) - 1.0
    ry = ((pixel_xy[..., 1] + u2) * 2.0 / float(full_resolution[1])) - 1.0
    rx = rx * camera.raster_to_view[0]
    ry = ry * camera.raster_to_view[1]

    d_view = math3.normalize(torch.stack([rx, ry, torch.ones_like(rx)], -1))
    vx, vy, vz = d_view[..., 0], d_view[..., 1], d_view[..., 2]
    m = camera.inv_view
    d_world = torch.stack(
        [m[i, 0] * vx + m[i, 1] * vy + m[i, 2] * vz for i in range(3)],
        dim=-1,
    )
    o_world = m[:, 3].expand(d_world.shape)
    return o_world, d_world, rng
