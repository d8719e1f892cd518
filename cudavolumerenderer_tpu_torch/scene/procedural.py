"""Procedural test volumes (numpy; copy of cudavolumerenderer_tpu/scene/procedural.py).

The reference ships binary volumes via git-LFS (Bucky.raw, *.vol, *.vdb)
that are stubbed out of the snapshot, so tests and benchmarks synthesize
deterministic stand-ins with the same shapes/statistics: a bucky-ball-like
blob field for the 32^3 raw config and a smoke-like plume for the
high-density streaming stress configs (BASELINE.md smoke scene,
128x128x50 @ scale 800).

The blob field is kept for the last few (resolution, n_blobs, seed): at
256^3 with 40 blobs it takes seconds of numpy, and one process (a driver
of benchmarks/, chip_smoke.py) often makes the same grid several times.
Every call still returns an array of its own.
"""

from __future__ import annotations

import functools

import numpy as np


def blob_volume(
    resolution=(32, 32, 32), n_blobs: int = 12, seed: int = 7
) -> np.ndarray:
    """Deterministic sum-of-Gaussians density in [0, 1], (Z, Y, X) layout."""
    return _blob_field(tuple(resolution), n_blobs, seed).copy()


@functools.lru_cache(maxsize=4)
def _blob_field(resolution, n_blobs: int, seed: int) -> np.ndarray:
    """blob_volume's field, kept read-only for the callers that share it."""
    nz, ny, nx = resolution[2], resolution[1], resolution[0]
    rs = np.random.RandomState(seed)
    z, y, x = np.meshgrid(
        np.linspace(0, 1, nz),
        np.linspace(0, 1, ny),
        np.linspace(0, 1, nx),
        indexing="ij",
    )
    field = np.zeros((nz, ny, nx), np.float32)
    for _ in range(n_blobs):
        c = rs.uniform(0.2, 0.8, size=3)
        s = rs.uniform(0.05, 0.15)
        field += np.exp(
            -((z - c[0]) ** 2 + (y - c[1]) ** 2 + (x - c[2]) ** 2)
            / (2 * s * s)
        ).astype(np.float32)
    field /= field.max()
    field.setflags(write=False)
    return field


def smoke_volume(resolution=(128, 128, 50), seed: int = 3) -> np.ndarray:
    """Smoke-plume-like density: vertical falloff + turbulent octaves."""
    nx, ny, nz = resolution
    rs = np.random.RandomState(seed)
    z, y, x = np.meshgrid(
        np.linspace(0, 1, nz),
        np.linspace(0, 1, ny),
        np.linspace(0, 1, nx),
        indexing="ij",
    )
    r2 = (x - 0.5) ** 2 + (y - 0.5) ** 2
    base = np.exp(-r2 / (0.05 + 0.15 * z)) * (1.0 - 0.6 * z)
    noise = np.zeros_like(base)
    for octave in range(3):
        n = 2 ** (octave + 2)
        coarse = rs.rand(n, n, n).astype(np.float32)
        # nearest-neighbor upsample to full res
        zi = (z * (n - 1)).astype(int)
        yi = (y * (n - 1)).astype(int)
        xi = (x * (n - 1)).astype(int)
        noise += coarse[zi, yi, xi] / (2.0**octave)
    field = np.clip(base * (0.5 + 0.5 * noise / noise.max()), 0.0, 1.0)
    return field.astype(np.float32)


def medical_volume(
    resolution=(256, 256, 256), n_blobs: int = 40, seed: int = 7
) -> np.ndarray:
    """CT-like density with the statistics the real MHD pipeline
    produces: the reference's converter min-max normalizes and applies
    smoothstep(0.2, 0.6) (scripts/convert-mhd/mhd_to_vdb.py:7-10, same
    transform as scene/mhd.py), which zeroes soft tissue/air below the
    0.2 threshold — most of a manix/artifix volume is exactly empty."""
    field = _blob_field(tuple(resolution), n_blobs, seed)
    lo, hi = float(field.min()), float(field.max())
    x = (field - lo) / max(hi - lo, 1e-30)
    t = np.clip((x - 0.2) / 0.4, 0.0, 1.0)
    return (t * t * (3.0 - 2.0 * t)).astype(np.float32)


def write_raw_uchar(path: str, density01: np.ndarray) -> None:
    """Write a volume as the 8-bit raw format the RawSceneBuilder reads
    (reference: RawSceneBuilder.h:143-160 — plain bytes, x-fastest)."""
    (np.clip(density01, 0, 1) * 255).astype(np.uint8).tofile(path)
