"""Image output: Radiance HDR and PNG writers, gamma/tonemap transform.

Port of cudavolumerenderer_tpu/utils/image.py (reference: Image.cpp:35-62,
ImageBufferTransfer.cu:80-114): `save_hdr` writes the RLE-free Radiance
.hdr the batch path saves, `save_png` the clamped 8-bit preview, and
`tonemap` the scale → gamma 1/2.2 → clamp chain.  Pure NumPy on host
images.  The JAX package writes with its native RGBE encoder when built;
the port's native binding (utils/native.rgbe_encode) gives the same
bytes, and the writer keeps NumPy so saving an image needs no build.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def tonemap(img: np.ndarray, scale: float = 1.0) -> np.ndarray:
    """scale → gamma 1/2.2 → clamp to [0,1] (ImageBufferTransfer.cu's
    ColorPixelTransform)."""
    x = np.maximum(np.asarray(img, np.float32) * scale, 0.0)
    return np.clip(np.power(x, 1.0 / 2.2), 0.0, 1.0)


def _rgbe_encode(rgb: np.ndarray) -> np.ndarray:
    """Float RGB → shared-exponent RGBE bytes."""
    rgb = np.maximum(rgb.astype(np.float32), 0.0)
    maxc = rgb.max(axis=-1)
    rgbe = np.zeros(rgb.shape[:-1] + (4,), np.uint8)
    nonzero = maxc >= 1e-32
    # frexp: maxc = m * 2^e with m in [0.5, 1)
    m, e = np.frexp(np.where(nonzero, maxc, 1.0))
    scale = np.where(nonzero, m * 256.0 / np.where(nonzero, maxc, 1.0), 0.0)
    rgbe[..., :3] = np.minimum(rgb * scale[..., None], 255.0).astype(np.uint8)
    rgbe[..., 3] = np.where(nonzero, e + 128, 0).astype(np.uint8)
    return rgbe


def _rgbe_decode(rgbe: np.ndarray) -> np.ndarray:
    e = rgbe[..., 3].astype(np.int32)
    scale = np.where(e > 0, np.ldexp(1.0, e - 136), 0.0)
    return (rgbe[..., :3].astype(np.float32) + 0.5) * scale[..., None]


def save_hdr(path: str, img: np.ndarray) -> None:
    """Write a Radiance .hdr (uncompressed scanlines).  img: (H, W, 3)."""
    img = np.asarray(img, np.float32)
    h, w = img.shape[:2]
    with open(path, "wb") as f:
        f.write(b"#?RADIANCE\n")
        f.write(b"FORMAT=32-bit_rle_rgbe\n\n")
        f.write(f"-Y {h} +X {w}\n".encode())
        f.write(_rgbe_encode(img[..., :3]).tobytes())


def load_hdr(path: str) -> np.ndarray:
    """Read back a flat (uncompressed) Radiance .hdr."""
    with open(path, "rb") as f:
        blob = f.read()
    header_end = blob.index(b"\n\n") + 2
    dims_end = blob.index(b"\n", header_end)
    dims = blob[header_end:dims_end].decode().split()
    h, w = int(dims[1]), int(dims[3])
    rgbe = np.frombuffer(
        blob[dims_end + 1 : dims_end + 1 + h * w * 4], np.uint8
    ).reshape(h, w, 4)
    return _rgbe_decode(rgbe)


def save_png(path: str, img01: np.ndarray) -> None:
    """Minimal PNG writer (8-bit RGB, zlib, no filtering).
    img01: (H, W, 3) in [0, 1]."""
    img8 = (np.clip(np.asarray(img01), 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    h, w = img8.shape[:2]
    raw = b"".join(b"\x00" + img8[y].tobytes() for y in range(h))

    def chunk(tag: bytes, payload: bytes) -> bytes:
        return (
            struct.pack(">I", len(payload)) + tag + payload
            + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF)
        )

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(raw, 6)))
        f.write(chunk(b"IEND", b""))
