"""Raw scene builder: 32^3 uchar volume + transfer-function albedo.

Port of cudavolumerenderer_tpu/scene/raw_builder.py (reference:
RawSceneBuilder.h:35-160): read 32^3 bytes, normalize density by its
max, synthesize albedo from a 100-entry green→red→blue transfer function
(including the reference's per-segment interpolation quirk,
RawSceneBuilder.h:95-140), box [-0.5,0.5]^3, sigma_t scale 40,
max_density 1, default 400x400 camera with fov 0.7°.  The tables are
numpy, built once at load time.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from ..ops.camera import Camera, make_camera
from .types import Scene, loader_device, make_medium, make_scene


def transfer_function() -> np.ndarray:
    """The reference's 100-entry piecewise transfer function
    (RawSceneBuilder.h:95-130): both segments interpolate with step
    (end-start)/100 but only run 20 and 80 entries, then snap the start
    to the full end color — reproduced exactly, discontinuity included."""
    func_length = 100.0
    entries = []
    start = np.array([0.02, 0.2, 0.02], np.float32)
    end = np.array([1.0, 0.02, 0.02], np.float32)
    for i in range(int(func_length * 1.0 / 5.0)):
        entries.append(start + i * (end - start) / func_length)
    start = end
    end = np.array([0.0, 0.02, 1.0], np.float32)
    for i in range(int(func_length * 4.0 / 5.0)):
        entries.append(start + i * (end - start) / func_length)
    rgb = np.stack(entries).astype(np.float32)
    return np.concatenate([rgb, np.ones((len(rgb), 1), np.float32)], axis=-1)


def albedo_from_density(density01: np.ndarray) -> np.ndarray:
    """albedo[i] = transferFunc[ceil(density * (len-1))]
    (RawSceneBuilder.h:133-139)."""
    tf = transfer_function()
    idx = np.ceil(density01 * (len(tf) - 1)).astype(np.int64)
    return tf[np.clip(idx, 0, len(tf) - 1)]


def load_raw_scene(
    path: str, resolution: Tuple[int, int, int] = (32, 32, 32), device="cuda"
) -> Tuple[Scene, Camera]:
    """Load a raw uchar volume file into a Scene + default Camera."""
    device = loader_device(device)
    nx, ny, nz = resolution
    n = nx * ny * nz
    with open(path, "rb") as f:
        raw = np.frombuffer(f.read(n), np.uint8)
    if raw.size != n:
        raise ValueError(f"raw file {path!r} has {raw.size} bytes, expected {n}")
    density = raw.astype(np.float32).reshape(nz, ny, nx)  # x-fastest
    dmax = density.max()
    if dmax > 0:
        density = density / dmax
    medium = make_medium(
        density, albedo_from_density(density), box_min=(-0.5, -0.5, -0.5),
        box_max=(0.5, 0.5, 0.5), scale=40.0, max_density=1.0, device=device,
    )
    return make_scene(medium), make_camera(device=device)
