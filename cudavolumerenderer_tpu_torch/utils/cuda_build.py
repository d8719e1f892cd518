"""Build a CUDA source of this package into a shared library and load it.

nvcc compiles the file into a library with a plain C interface, loaded
with ctypes (no PyTorch headers, so a build takes seconds).  The library
lands in the package's `_build/` directory (listed in .gitignore), named
by a hash of the source and the flags, so an edited source rebuilds and
an unchanged one is reused; the hash covers the headers (`*.cuh`) beside
the source too, which the kernels share.  Nothing is built at import time.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"

#: sm_90a (Hopper); no --use_fast_math, and -fmad=false so the kernels'
#: float arithmetic matches their plain torch versions op for op;
#: -Xptxas=-v reports registers and spills in the build log
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
    "-shared", "-Xcompiler", "-fPIC", "-fmad=false", "-Xptxas=-v",
)


@dataclasses.dataclass
class BuiltLibrary:
    lib: ctypes.CDLL
    path: Path
    seconds: float  # nvcc wall time; 0.0 when the library was reused
    log: str  # nvcc's output (ptxas register/spill report), kept beside it


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME  # noqa: PLC0415

    if CUDA_HOME is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def build_library(source: Path) -> BuiltLibrary:
    """Compile `source` (if its hash is new) and load the library."""
    headers = sorted(source.parent.glob("*.cuh"))
    digest = hashlib.sha256(
        b"".join(p.read_bytes() for p in (source, *headers))
        + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    out = BUILD_DIR / f"lib{source.stem}-{digest}.so"
    log_path = out.with_suffix(".log")
    seconds, log = 0.0, ""
    if out.exists() and log_path.exists():
        log = log_path.read_text()
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(source)],
            capture_output=True, text=True, check=False,
        )
        seconds = time.perf_counter() - t0
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {source.name}:\n{log}")
        log_path.write_text(log)
        os.replace(tmp, out)  # atomic: a concurrent build never sees half a file
    return BuiltLibrary(ctypes.CDLL(str(out)), out, seconds, log)
