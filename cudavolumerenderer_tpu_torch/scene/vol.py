"""Mitsuba binary gridvolume (.vol) v3 reader/writer (numpy; port of
cudavolumerenderer_tpu/scene/vol.py, whose reader returns a read-only
view of the file's bytes: this one returns a writable copy, which torch
tensors may share).

Pure-NumPy implementation of the format the reference parses in
XmlSceneBuilder::loadVolFile (reference:
implementation/src/XmlSceneBuilder.h:195-266): header 'VOL', version 3,
encoding int32, dims (x, y, z) int32, channel count int32, AABB 6 floats,
then x-fastest float32 data.  The writer exists so tests can round-trip
and synthesize scenes in the reference's own format.
"""

from __future__ import annotations

import struct
from typing import NamedTuple

import numpy as np


class VolData(NamedTuple):
    data: np.ndarray  # (Z, Y, X) or (Z, Y, X, C) float32
    box_min: np.ndarray  # (3,)
    box_max: np.ndarray  # (3,)


def read_vol(path: str) -> VolData:
    with open(path, "rb") as f:
        header = f.read(3)
        if header != b"VOL":
            raise ValueError(f"{path!r}: not a Mitsuba VOL file")
        (version,) = struct.unpack("<B", f.read(1))
        if version != 3:
            raise ValueError(f"{path!r}: unsupported VOL version {version}")
        encoding, nx, ny, nz, channels = struct.unpack("<5i", f.read(20))
        if encoding != 1:
            raise ValueError(
                f"{path!r}: only float32 encoding (1) supported, got {encoding}"
            )
        box = struct.unpack("<6f", f.read(24))
        count = nx * ny * nz * channels
        data = np.frombuffer(f.read(count * 4), "<f4", count)
    if channels == 1:
        data = data.reshape(nz, ny, nx)
    else:
        data = data.reshape(nz, ny, nx, channels)
    return VolData(
        data=np.array(data, np.float32),
        box_min=np.asarray(box[:3], np.float32),
        box_max=np.asarray(box[3:], np.float32),
    )


def write_vol(path: str, data: np.ndarray, box_min, box_max) -> None:
    data = np.asarray(data, np.float32)
    if data.ndim == 3:
        nz, ny, nx = data.shape
        channels = 1
    else:
        nz, ny, nx, channels = data.shape
    with open(path, "wb") as f:
        f.write(b"VOL")
        f.write(struct.pack("<B", 3))
        f.write(struct.pack("<5i", 1, nx, ny, nz, channels))
        f.write(struct.pack("<6f", *np.asarray(box_min, np.float32),
                            *np.asarray(box_max, np.float32)))
        f.write(data.astype("<f4").tobytes())
