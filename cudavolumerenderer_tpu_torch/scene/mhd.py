"""MetaImage (.mhd/.raw) loader with the reference pipeline's semantics.

Port of cudavolumerenderer_tpu/scene/mhd.py (reference:
scripts/convert-mhd/mhd_to_vdb.py:37-89): parse the header, read the
(possibly zlib-compressed) element data, min-max normalize, apply
smoothstep(0.2, 0.6) for density, and synthesize a red-channel albedo
that follows density (affine in density, so fastSK keeps a flat table).
Scale and box match the VDB scene loader (reference:
VDBSceneBuilder.h:69-78: AABB [-0.5,0.5]^3, scale 100).
"""

from __future__ import annotations

import os
import zlib
from typing import Tuple

import numpy as np

from ..ops.camera import Camera, make_camera
from .types import Scene, loader_device, make_medium, make_scene

_ELEMENT_TYPES = {
    "MET_CHAR": np.int8,
    "MET_UCHAR": np.uint8,
    "MET_SHORT": np.int16,
    "MET_USHORT": np.uint16,
    "MET_INT": np.int32,
    "MET_UINT": np.uint32,
    "MET_FLOAT": np.float32,
    "MET_DOUBLE": np.float64,
}


def smooth_step(edge0: float, edge1: float, x: np.ndarray) -> np.ndarray:
    """Hermite smoothstep (reference: mhd_to_vdb.py:7-10)."""
    t = np.clip((x - edge0) / (edge1 - edge0), 0.0, 1.0)
    return t * t * (3.0 - 2.0 * t)


def read_mhd(path: str) -> np.ndarray:
    """Read a .mhd/.mha volume into a float32 (Z, Y, X) array.  An .mha
    (``ElementDataFile = LOCAL``) keeps its payload right after that
    header line."""
    with open(path, "rb") as f:
        blob_all = f.read()
    header = {}
    data_offset = None
    pos = 0
    while pos < len(blob_all):
        nl = blob_all.find(b"\n", pos)
        if nl < 0:
            nl = len(blob_all)
        line = blob_all[pos:nl].decode("latin-1", errors="replace")
        pos = nl + 1
        if "=" not in line:
            continue
        key, value = line.split("=", 1)
        header[key.strip()] = value.strip()
        if key.strip() == "ElementDataFile":
            data_offset = pos  # binary payload starts here for LOCAL
            break
    dims = [int(v) for v in header["DimSize"].split()]
    if len(dims) != 3:
        raise ValueError(f"{path!r}: only 3-D volumes supported")
    nx, ny, nz = dims
    dtype = _ELEMENT_TYPES[header.get("ElementType", "MET_UCHAR")]
    byte_order_msb = header.get("BinaryDataByteOrderMSB", "False") == "True"
    compressed = header.get("CompressedData", "False") == "True"
    datafile = header["ElementDataFile"]
    if datafile == "LOCAL":
        blob = blob_all[data_offset:]
    else:
        raw_path = os.path.join(
            os.path.dirname(os.path.abspath(path)), datafile
        )
        with open(raw_path, "rb") as f:
            blob = f.read()
    if compressed:
        blob = zlib.decompress(blob)
    data = np.frombuffer(blob, dtype, nx * ny * nz)
    if byte_order_msb:
        data = data.byteswap()
    return data.astype(np.float32).reshape(nz, ny, nx)


def load_mhd_scene(path: str, device="cuda") -> Tuple[Scene, Camera]:
    device = loader_device(device)
    image = read_mhd(path)
    dmin, dmax = float(image.min()), float(image.max())
    normalized = (image - dmin) / max(dmax - dmin, 1e-20)
    density = smooth_step(0.2, 0.6, normalized).astype(np.float32)

    albedo = np.zeros(density.shape + (3,), np.float32)
    albedo[..., 0] = density  # red channel follows density

    medium = make_medium(
        density,
        albedo,
        box_min=(-0.5, -0.5, -0.5),
        box_max=(0.5, 0.5, 0.5),
        scale=100.0,
        max_density=float(density.max()),
        device=device,
    )
    return make_scene(medium), make_camera(device=device)
