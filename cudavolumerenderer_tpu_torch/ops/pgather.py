"""The five gather kernels of the gather microbenchmark.

Port of the Pallas TPU kernels of benchmarks/micro_pgather.py, which
measure how fast a kernel can read a density table at random indices.
Each becomes a hand-written CUDA kernel (csrc/pgather.cu, design notes
there); this module holds each kernel's plain PyTorch version, the
wrapper `run_*` that picks between them by the tensors' device, the
launch counts, the bytes each must move, and the one torch call that
computes the same function (a yardstick for timing, never called here).

  kernel   Pallas body (micro_pgather.py)  computes
  taa1     kern_taa1 :284     out[r, l] = tab[r, idx[r, l]]; tab, idx (R, 128)
  taa0     kern_taa0 :310     out[r, l] = tab[idx[r, l], l]; tab, idx (R, 128)
  vmem     pallas_vmem :334   out = tab[idx]; tab (V,), the table held whole
  stream   pallas_stream :354 out = tab[idx], 0 outside the table: the
                              Pallas kernel's masked take on each of S
                              shards of C = V / S entries, in turn
  binned   pallas_binned :390 out[s, k] = tab[idx[s, k]], idx[s, .] inside
                              shard s; idx (S, K / 128, 128)

What bounds them: each index read once, each needed table value read
once, each output written once (`gather_bytes`), and in practice one
32-byte sector per random value.  taa0 and stream give each thread 4
consecutive lanes (a 16-byte index load, four independent value loads
in flight, a 16-byte store) and read the table where it lies, in L2 while
the touched sectors fit it: taa0 stages nothing and takes any R, stream
walks no shards.

Tables are float32 and indices int32, as in JAX, into the kernels; the
plain versions widen the indices to int64 because torch's take and
gather need it.  Indices must lie in the table: the plain versions
raise otherwise, and a kernel then gives NaN (0 for stream, which masks)
and reads nothing outside its table.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

TABLE_W = 128  # lanes per row
NAMES = ("taa1", "taa0", "vmem", "stream", "binned")

_SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "pgather.cu"


# -- plain versions -------------------------------------------------------

def taa1_gather(tab, idx):
    return torch.gather(tab, 1, idx.long())


def taa0_gather(tab, idx):
    return torch.gather(tab, 0, idx.long())


def vmem_gather(tab, idx):
    return torch.take(tab, idx.long())


def stream_gather(tab, idx, shards: int):
    """The Pallas kernel's grid over S shards: on shard s every lane takes
    tab[s*C + clip(idx - s*C)] where its index lies in the shard, and keeps
    what it had elsewhere (0 before the first shard)."""
    C = tab.shape[0] // shards
    out = torch.zeros(idx.shape, dtype=torch.float32, device=idx.device)
    for s in range(shards):
        loc = idx - s * C
        inb = (loc >= 0) & (loc < C)
        vals = torch.take(tab[s * C:(s + 1) * C], loc.clamp(0, C - 1).long())
        out = torch.where(inb, vals, out)
    return out


def binned_gather(tab, idx):
    """Shard s of C = V / S entries, taken at idx[s] - s*C."""
    S = idx.shape[0]
    C = tab.shape[0] // S
    return torch.stack([
        torch.take(tab[s * C:(s + 1) * C], (idx[s] - s * C).long())
        for s in range(S)
    ])


#: the one torch call that computes each kernel's function, given the
#: indices already widened to int64: the yardstick a kernel is timed
#: against (chip_smoke.py's library_ms).  The port never calls it.
YARDSTICKS = {
    "taa1": lambda tab, i64: torch.gather(tab, 1, i64),
    "taa0": lambda tab, i64: torch.gather(tab, 0, i64),
    "vmem": torch.take,
    "stream": torch.take,
    "binned": torch.take,  # binned's indices are absolute
}


# -- bytes each kernel must move ---------------------------------------------

def gather_bytes(n: int, values: int | None = None, value_bytes: int = 4) -> int:
    """The least bytes a gather of n int32 indices into n float32 outputs
    moves: each index read once, each of `values` distinct table entries
    read once (n when every output reads its own), each output written
    once.  With `values` the distinct 32-byte sectors touched and
    value_bytes=32 it is the floor a random gather from device memory
    cannot go under."""
    return 4 * n + value_bytes * (n if values is None else values) + 4 * n


def touched(name: str, idx):
    """(distinct table entries, distinct 32-byte sectors) that kernel
    `name` reads on these in-range indices, with the table 32-byte
    aligned."""
    pos = idx.long()  # the flat table position each output reads
    if name == "taa1":
        pos = torch.arange(pos.shape[0], device=pos.device)[:, None] * TABLE_W + pos
    elif name == "taa0":
        pos = pos * TABLE_W + torch.arange(TABLE_W, device=pos.device)
    pos = pos.reshape(-1)
    return int(pos.unique().numel()), int((pos >> 3).unique().numel())


# -- the CUDA kernels -----------------------------------------------------

class GatherLibrary:
    """csrc/pgather.cu, built at first use and loaded once for all five
    kernels."""

    def __init__(self):
        self._built = None

    def library(self):
        """Build (or reuse) and load the library; returns the
        utils.cuda_build.BuiltLibrary."""
        if self._built is None:
            from ..utils import cuda_build  # noqa: PLC0415

            built = cuda_build.build_library(_SOURCE)
            lib = built.lib
            ptrs = [ctypes.c_void_p] * 3
            i64 = ctypes.c_int64
            for name, sizes in (("taa1", 1), ("taa0", 1), ("vmem", 2),
                                ("stream", 2), ("binned", 3)):
                fn = getattr(lib, f"{name}_launch")
                fn.argtypes = ptrs + [i64] * sizes + [ctypes.c_void_p]
                fn.restype = ctypes.c_int
            self._built = built
        return self._built


LIBRARY = GatherLibrary()


class GatherKernel:
    """One kernel of csrc/pgather.cu, launched through its C entry point
    and counted.  `launches` counts launches made now; a launch recorded
    into a CUDA graph being captured counts in `captured` instead, and
    whoever replays the graph adds to `launches` what each replay runs."""

    def __init__(self, name: str):
        self.name = name
        self.launches = 0  # CUDA launches; the plain version is not counted
        self.captured = 0

    def launch(self, tensors, sizes):
        """tensors: (tab, idx), the checked inputs; sizes: the C entry
        point's 64-bit size arguments.  Returns the output, shaped as idx."""
        tab, idx = tensors
        out = torch.empty(idx.shape, dtype=torch.float32, device=idx.device)
        fn = getattr(LIBRARY.library().lib, f"{self.name}_launch")
        with torch.cuda.device(idx.device):
            err = fn(tab.data_ptr(), idx.data_ptr(), out.data_ptr(), *sizes,
                     torch.cuda.current_stream(idx.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"{self.name} launch failed: CUDA error {err}")
        if torch.cuda.is_current_stream_capturing():
            self.captured += 1
        else:
            self.launches += 1
        return out


KERNELS = {name: GatherKernel(name) for name in NAMES}


def _check(name, tab, idx, tab_shape=None, idx_shape=None):
    dev = idx.device
    for arg, x, dtype, shape in (("tab", tab, torch.float32, tab_shape),
                                 ("idx", idx, torch.int32, idx_shape)):
        if x.device != dev or x.dtype != dtype or (
                shape is not None and tuple(x.shape) != shape):
            want = "" if shape is None else f" {shape}"
            raise ValueError(
                f"{name}: {arg} must be {dtype}{want} on {dev}, got "
                f"{x.dtype} {tuple(x.shape)} on {x.device}"
            )
        if not x.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
    if dev.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {dev}")


def _rows(name, tab, idx):
    R = idx.shape[0]
    _check(name, tab, idx, (R, TABLE_W), (R, TABLE_W))
    return R


def run_taa1(tab, idx):
    """out[r, l] = tab[r, idx[r, l]] for (R, 128) tab and idx: the plain
    version for CPU tensors, the CUDA kernel for CUDA tensors."""
    if idx.device.type == "cpu":
        return taa1_gather(tab, idx)
    R = _rows("taa1", tab, idx)
    return KERNELS["taa1"].launch((tab, idx), (R,))


def run_taa0(tab, idx):
    """out[r, l] = tab[idx[r, l], l] for (R, 128) tab and idx, any R."""
    if idx.device.type == "cpu":
        return taa0_gather(tab, idx)
    R = _rows("taa0", tab, idx)
    return KERNELS["taa0"].launch((tab, idx), (R,))


def run_vmem(tab, idx):
    """out = tab[idx] for a 1-D tab and any idx."""
    if idx.device.type == "cpu":
        return vmem_gather(tab, idx)
    _check("vmem", tab, idx, (tab.shape[0],))
    return KERNELS["vmem"].launch((tab, idx), (tab.shape[0], idx.numel()))


def run_stream(tab, idx, shards: int):
    """out = tab[idx], 0 outside the table, as S masked shard takes give
    it (`stream_gather`); the table must split into S equal shards."""
    if idx.device.type == "cpu":
        return stream_gather(tab, idx, shards)
    V = tab.shape[0]
    _check("stream", tab, idx, (V,))
    if shards <= 0 or V % shards:
        raise ValueError(f"stream: {V} entries do not split into {shards} shards")
    return KERNELS["stream"].launch((tab, idx), (V, idx.numel()))


def run_binned(tab, idx):
    """out[s, k] = tab[idx[s, k]] for idx (S, K / 128, 128) binned by
    shard of C = V / S entries; the table must split into S equal
    shards."""
    if idx.device.type == "cpu":
        return binned_gather(tab, idx)
    V = tab.shape[0]
    S = idx.shape[0]
    _check("binned", tab, idx, (V,))
    if idx.dim() != 3 or idx.shape[2] != TABLE_W or S == 0 or V % S:
        raise ValueError(
            f"binned: idx must be (S, K / 128, 128) with S dividing {V}, "
            f"got {tuple(idx.shape)}"
        )
    K = idx.numel() // S
    return KERNELS["binned"].launch((tab, idx), (V // S, S, K))


#: each kernel's (wrapper, plain version), which take the same arguments
WRAPPERS = {
    "taa1": (run_taa1, taa1_gather),
    "taa0": (run_taa0, taa0_gather),
    "vmem": (run_vmem, vmem_gather),
    "stream": (run_stream, stream_gather),
    "binned": (run_binned, binned_gather),
}
