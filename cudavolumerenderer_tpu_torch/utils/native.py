"""ctypes bindings for the native data-path library.

Port of cudavolumerenderer_tpu/utils/native.py.  The C++ sources are the
repository's own `csrc/cvr_native.cpp` (Morton re-layout, brick packing,
RGBE encoding) and `csrc/cvr_vdb.cpp` (the OpenVDB archive reader with
the reference VDBAdapter's sparse->dense flattening), read in place.
g++ builds them at first use, without -march=native so the library runs
on any x86-64 host, into the package's `_build/` directory (listed in
.gitignore), named by a hash of the sources and the flags; a lock file
keeps concurrent first uses to one build.  A failed build raises: there
is no NumPy fallback, and the prebuilt `csrc/libcvr_native.so` is never
loaded.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import time
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from .cuda_build import BUILD_DIR

SOURCES = tuple(
    Path(__file__).resolve().parents[2] / "csrc" / name
    for name in ("cvr_native.cpp", "cvr_vdb.cpp")
)
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17")

BRICK_SHAPE = (4, 4, 8)  # (z, y, x) voxels = 128 entries = one vector row

_P, _I32, _I64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
_STR = ctypes.c_char_p
#: argument types of the C entry points (csrc/cvr_native.cpp, cvr_vdb.cpp)
_SIGNATURES = {
    "cvr_morton_reorder": [_P, _P, _I32, _I32, _I32, _I32],
    "cvr_brick_pack": [_P, _P, _P, _I32, _I32, _I32, _I32],
    "cvr_brick_max": [_P, _P, _I32, _I32, _I32],
    "cvr_rgbe_encode": [_P, _P, _I64],
    "cvr_vdb_grid_info": [_STR, _STR, _P, ctypes.POINTER(_I32)],
    "cvr_vdb_densify": [_STR, _STR, _P, _P, _I32],
    "cvr_blosc_decompress": [_P, _I64, _P, _I64],
}

_LIB: Optional[ctypes.CDLL] = None
#: g++ wall seconds of this process's build (0.0 when the library was reused)
build_seconds = 0.0


def library_path() -> Path:
    digest = hashlib.sha256(
        b"".join(s.read_bytes() for s in SOURCES) + " ".join(CXX_FLAGS).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"libcvr_native-{digest}.so"


def _build(out: Path) -> None:
    global build_seconds
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(out.with_suffix(".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists():  # another process built it while we waited
            return
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        t0 = time.perf_counter()
        proc = subprocess.run(
            ["g++", *CXX_FLAGS, "-o", str(tmp), *map(str, SOURCES), "-lz"],
            capture_output=True, text=True, check=False,
        )
        build_seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            raise RuntimeError(
                f"g++ failed on {', '.join(s.name for s in SOURCES)}:\n"
                f"{proc.stdout}{proc.stderr}"
            )
        os.replace(tmp, out)  # atomic: a reader never sees half a file


def load() -> ctypes.CDLL:
    """The native library, built on first use; raises if it cannot be."""
    global _LIB
    if _LIB is None:
        out = library_path()
        if not out.exists():
            _build(out)
        lib = ctypes.CDLL(str(out))
        for name, args in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = args, ctypes.c_int
        lib.cvr_vdb_last_error.argtypes = []
        lib.cvr_vdb_last_error.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def _check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} failed: {rc}")


def morton_reorder(volume_zyx: np.ndarray) -> np.ndarray:
    """(Z,Y,X[,C]) x-fastest -> Morton-ordered flat array (Volume.h
    ZYXToMortonOrder semantics; requires equal power-of-two dims)."""
    v = np.ascontiguousarray(volume_zyx, np.float32)
    nz, ny, nx = v.shape[:3]
    c = 1 if v.ndim == 3 else v.shape[3]
    out = np.empty(nx * ny * nz * c, np.float32)
    rc = load().cvr_morton_reorder(_ptr(v), _ptr(out), nx, ny, nz, c)
    if rc == -1:
        raise ValueError("morton reorder needs equal power-of-two dims")
    _check(rc, "cvr_morton_reorder")
    return out


def brick_pack(
    volume_zyx: np.ndarray,
) -> Tuple[np.ndarray, np.ndarray, Tuple[int, int, int]]:
    """(Z,Y,X[,C]) -> (n_bricks, 128, C) brick-major layout + per-brick
    majorant of the last channel.  Brick = 4x4x8 (z,y,x), x-fastest.

    Returns (bricks, brick_max, (nbx, nby, nbz))."""
    v = np.ascontiguousarray(volume_zyx, np.float32)
    nz, ny, nx = v.shape[:3]
    c = 1 if v.ndim == 3 else v.shape[3]
    bz, by, bx = BRICK_SHAPE
    nbx, nby, nbz = -(-nx // bx), -(-ny // by), -(-nz // bz)
    n_bricks = nbx * nby * nbz
    out = np.empty((n_bricks, 128, c), np.float32)
    bmax = np.empty((n_bricks,), np.float32)
    _check(load().cvr_brick_pack(_ptr(v), _ptr(out), _ptr(bmax), nx, ny, nz, c),
           "cvr_brick_pack")
    return out, bmax, (nbx, nby, nbz)


def brick_max(density_zyx: np.ndarray) -> np.ndarray:
    """(nbz, nby, nbx) per-brick maxima of a (Z, Y, X) density."""
    v = np.ascontiguousarray(density_zyx, np.float32)
    nz, ny, nx = v.shape
    bz, by, bx = BRICK_SHAPE
    out = np.empty((-(-nz // bz), -(-ny // by), -(-nx // bx)), np.float32)
    _check(load().cvr_brick_max(_ptr(v), _ptr(out), nx, ny, nz),
           "cvr_brick_max")
    return out


def rgbe_encode(rgb: np.ndarray) -> np.ndarray:
    """Float (..., 3) -> RGBE uint8 (..., 4)."""
    img = np.ascontiguousarray(rgb, np.float32)
    n = int(np.prod(img.shape[:-1]))
    out = np.empty(img.shape[:-1] + (4,), np.uint8)
    _check(load().cvr_rgbe_encode(_ptr(img), _ptr(out), n), "cvr_rgbe_encode")
    return out


def _vdb_error(lib, what: str) -> RuntimeError:
    return RuntimeError(f"{what}: {lib.cvr_vdb_last_error().decode()}")


def vdb_grid_info(path: str, grid_name: str):
    """Active-voxel bbox (x0, y0, z0, x1, y1, z1) + channel count of a
    grid in a .vdb archive.  Returns (bbox6, channels)."""
    lib = load()
    bbox = np.zeros(6, np.int32)
    channels = ctypes.c_int32(0)
    rc = lib.cvr_vdb_grid_info(
        path.encode(), grid_name.encode(), _ptr(bbox), ctypes.byref(channels)
    )
    if rc == -2:
        raise KeyError(f"grid {grid_name!r} has no active voxels")
    if rc != 0:
        raise _vdb_error(lib, "cvr_vdb_grid_info")
    return bbox, int(channels.value)


def vdb_densify(path: str, grid_name: str, channels: int, bbox=None):
    """Densify a .vdb grid over its active bbox (or a given (x, y, z)
    bbox) into a (Z, Y, X, channels) float32 array, inactive voxels 0 —
    the reference VDBAdapter's flattening.  Returns (array, bbox)."""
    lib = load()
    if bbox is None:
        bbox, file_channels = vdb_grid_info(path, grid_name)
        if file_channels != channels:
            raise RuntimeError(
                f"grid {grid_name!r} has {file_channels} channels, "
                f"expected {channels}"
            )
    bbox = np.ascontiguousarray(bbox, np.int32)
    nx, ny, nz = (int(bbox[3 + a] - bbox[a] + 1) for a in range(3))
    out = np.zeros((nz, ny, nx, channels), np.float32)
    rc = lib.cvr_vdb_densify(
        path.encode(), grid_name.encode(), _ptr(bbox), _ptr(out), channels
    )
    if rc != 0:
        raise _vdb_error(lib, "cvr_vdb_densify")
    return out, bbox
