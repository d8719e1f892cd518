"""Brick-binned Woodcock tracking: the kernel of the brickSK scheduler.

Port of cudavolumerenderer_tpu/ops/pallas/tracking.py.  The Pallas TPU
kernel becomes a hand-written CUDA kernel (csrc/tracking.cu, design notes
there); this module holds its plain PyTorch version `track_steps`, the
wrapper `run_track_steps` that picks between them by the tensors'
device, and the host-side brick tables.

Lanes arrive binned by models/brick.py: each row of 128 lanes tracks
inside one 4x4x8 (z, y, x) brick of the density grid, whose dilated
5x5x9 = 225-voxel table (the brick plus a one-voxel border on the high
side, x-fastest, flat (lz*5+ly)*9+lx, zero-padded to 256) holds every
trilinear tap reachable from inside it.  A lane runs up to K steps: a
flight draw under the per-lane reciprocal majorant `inv_sig`, the exit
test (EXIT_BRICK, or EXIT_BOX where the box exit comes first), a 30-bit
stochastic trilinear tap (three 10-bit fields of one draw), the table
lookup and the acceptance test `not (rho * inv_rho < u2)`, which gives
SCATTER and the tap's flat index.  Rays are in voxel coordinates, t in
world units, so the kernel needs no scene geometry.

Kernel inputs (the Pallas kernel's 19, documented there as 17):
  tables     (NB, 256) f32    the shared dilated-brick table
  row_brick  (R,) int64       each row's brick index into `tables`
  f          (N_F, R, 128) f32, rows F_*: ox, oy, oz, dx, dy, dz (voxel
             space), t, max_t, brick_exit (world t), base_x, base_y,
             base_z (the brick's lowest voxel), inv_sig = 1/(scale *
             rho_max_brick), inv_rho = inv_sig * scale
  rng        (2, R, 128) int64 holding uint32 (state, inc)
  status     (R, 128) int32   RUNNING lanes step; any other status sits out
Outputs: t (R, 128) f32, status (R, 128) int32, tap (R, 128) int32 (the
local flat index at a scatter, else 0), rng_state (R, 128) int64.  The
Pallas kernel took each row's table as two gathered (R, 128) rows; here
the kernel reads the shared table at the row's brick index.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..constants import EPSILON
from .rng import RngState, next_uint32

# Interior brick size (z, y, x) and dilated table size.
BRICK = (4, 4, 8)
DILATED = (5, 5, 9)  # 225 voxels
TABLE_W = 128  # lanes per row
ROW = 2 * TABLE_W  # one brick's table, zero-padded past 225

# Status codes reported per lane.
RUNNING = 0
SCATTER = 1
EXIT_BRICK = 2
EXIT_BOX = 3

# Float input rows ((N_F, R, 128) float32), the Pallas kernel's order.
(F_OX, F_OY, F_OZ, F_DX, F_DY, F_DZ, F_T, F_MAXT, F_BEXIT, F_BASEX,
 F_BASEY, F_BASEZ, F_INVSIG, F_INVRHO) = range(14)
N_F = 14

_SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "tracking.cu"


def build_dilated_bricks(density_zyx: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(NB, 2, 128) dilated brick tables and the (nbz, nby, nbx) dilated
    majorants (the max over each brick's 225 entries).  Grid dimensions
    need not be multiples of the brick: the high side is zero-padded."""
    d = density_zyx.to(torch.float32)
    nz, ny, nx = d.shape
    bz, by, bx = BRICK
    dz, dy, dx = DILATED
    nbz, nby, nbx = -(-nz // bz), -(-ny // by), -(-nx // bx)
    padded = F.pad(
        d, (0, nbx * bx + 1 - nx, 0, nby * by + 1 - ny, 0, nbz * bz + 1 - nz)
    )
    win = (
        padded.unfold(0, dz, bz).unfold(1, dy, by).unfold(2, dx, bx)
        .reshape(nbz, nby, nbx, dz * dy * dx)
    )
    majorant = torch.amax(win, dim=-1)
    tables = F.pad(win.reshape(-1, dz * dy * dx), (0, ROW - dz * dy * dx))
    return tables.reshape(-1, 2, TABLE_W), majorant


def _uniform(bits: torch.Tensor) -> torch.Tensor:
    return (bits >> 8).to(torch.float32) * (1.0 / (1 << 24))


def track_steps(tables, row_brick, f, rng, status, n_steps: int, taps=None):
    """Plain PyTorch version of the tracking kernel, with its signature
    (module docstring): n_steps masked steps, every lane in lockstep.  A
    list given as `taps` receives, per step, the flat table positions that
    step reads."""
    row_tab = tables[row_brick]  # (R, 256)
    ox, oy, oz, dx, dy, dz, t, max_t, bexit, bx, by, bz, inv_sig, inv_rho = f
    st = RngState(state=rng[0], inc=rng[1])
    eff_exit = torch.minimum(bexit, max_t)
    exit_code = torch.where(max_t <= bexit, EXIT_BOX, EXIT_BRICK).to(status.dtype)
    tap = torch.zeros_like(status)
    axes = ((ox, dx, bx, DILATED[2]), (oy, dy, by, DILATED[1]),
            (oz, dz, bz, DILATED[0]))

    for _ in range(n_steps):
        active = status == RUNNING
        bits1, st = next_uint32(st, active)
        step = -torch.log(torch.clamp(_uniform(bits1), min=EPSILON)) * inv_sig
        t = torch.where(active, t + step, t)
        crossed = active & (t >= eff_exit)
        status = torch.where(crossed, exit_code, status)
        still = active & ~crossed

        bits2, st = next_uint32(st, still)
        idx = []
        for a, (o_a, d_a, b_a, n) in enumerate(axes):
            local = o_a + t * d_a - b_a
            fl = torch.floor(local)
            u = ((bits2 >> (10 * a)) & 0x3FF).to(torch.float32) * (1.0 / 1024.0)
            idx.append(torch.clamp(
                fl.to(torch.int64) + (u < local - fl).to(torch.int64), 0, n - 1
            ))
        flat = (idx[2] * DILATED[1] + idx[1]) * DILATED[2] + idx[0]
        rho = torch.gather(row_tab, 1, flat)
        if taps is not None:
            taps.append((row_brick[:, None] * ROW + flat)[still])

        bits3, st = next_uint32(st, still)
        accept = still & ~(rho * inv_rho < _uniform(bits3))
        status = torch.where(accept, SCATTER, status)
        tap = torch.where(accept, flat.to(tap.dtype), tap)
    return t, status, tap, st.state


#: integer and float operations a kernel step that taps the table does at
#: least (csrc/tracking.cu): the flight draw, the three-axis tap and the
#: acceptance draw, each PCG draw 9 operations
STEP_OPS = 60


def track_bytes(n_rows: int, table_words: int) -> int:
    """The least bytes one kernel call moves: every input row of R rows of
    128 lanes read once (row_brick, f, rng, status), every output written
    once (t, status, tap, rng_state), and the `table_words` distinct table
    words its taps read (data-dependent: count them with
    `track_steps(..., taps=)`)."""
    lanes = n_rows * TABLE_W
    read = 8 * n_rows + (N_F * 4 + 2 * 8 + 4) * lanes
    written = (4 + 4 + 4 + 8) * lanes
    return read + written + 4 * table_words


class TrackKernel:
    """The CUDA tracking kernel: built from csrc/tracking.cu at first use,
    launched through its C entry point, and counted.  `launches` counts
    launches made now; a launch recorded into a CUDA graph being captured
    counts in `captured` instead."""

    def __init__(self):
        self.launches = 0  # CUDA launches; the plain version is not counted
        self.captured = 0
        self._built = None

    def library(self):
        """Build (or reuse) and load the kernel library; returns the
        utils.cuda_build.BuiltLibrary."""
        if self._built is None:
            from ..utils import cuda_build  # noqa: PLC0415

            built = cuda_build.build_library(_SOURCE)
            fn = built.lib.track_launch
            fn.argtypes = [ctypes.c_void_p] * 9 + [
                ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
            ]
            fn.restype = ctypes.c_int
            self._built = built
        return self._built

    def launch(self, tables, row_brick, f, rng, status, n_steps: int):
        R = status.shape[0]
        dev = status.device
        for name, x, dtype, shape in (
            ("tables", tables, torch.float32, (tables.shape[0], ROW)),
            ("row_brick", row_brick, torch.int64, (R,)),
            ("f", f, torch.float32, (N_F, R, TABLE_W)),
            ("rng", rng, torch.int64, (2, R, TABLE_W)),
            ("status", status, torch.int32, (R, TABLE_W)),
        ):
            if x.device != dev or x.dtype != dtype or tuple(x.shape) != shape:
                raise ValueError(
                    f"tracking: {name} must be {dtype} {shape} on {dev}, got "
                    f"{x.dtype} {tuple(x.shape)} on {x.device}"
                )
            if not x.is_contiguous():
                raise ValueError(f"tracking: {name} must be contiguous")
        fn = self.library().lib.track_launch
        t_out = torch.empty((R, TABLE_W), dtype=torch.float32, device=dev)
        status_out = torch.empty_like(status)
        tap_out = torch.empty_like(status)
        rng_out = torch.empty((R, TABLE_W), dtype=torch.int64, device=dev)
        with torch.cuda.device(dev):
            err = fn(
                tables.data_ptr(), row_brick.data_ptr(), f.data_ptr(),
                rng.data_ptr(), status.data_ptr(), t_out.data_ptr(),
                status_out.data_ptr(), tap_out.data_ptr(), rng_out.data_ptr(),
                R, n_steps, torch.cuda.current_stream(dev).cuda_stream,
            )
        if err != 0:
            raise RuntimeError(f"tracking launch failed: CUDA error {err}")
        if torch.cuda.is_current_stream_capturing():
            self.captured += 1
        else:
            self.launches += 1
        return t_out, status_out, tap_out, rng_out


KERNEL = TrackKernel()


def run_track_steps(tables, row_brick, f, rng, status, n_steps: int):
    """n_steps tracking steps on R binned rows (signature of
    `track_steps`): the plain version for CPU tensors, the CUDA kernel
    for CUDA tensors."""
    if status.device.type == "cpu":
        return track_steps(tables, row_brick, f, rng, status, n_steps)
    if status.device.type == "cuda":
        return KERNEL.launch(tables, row_brick, f, rng, status, n_steps)
    raise ValueError(f"tracking: no kernel for device {status.device}")


def random_track_state(
    majorant: torch.Tensor, n_rows: int, seed: int, scale: float,
    vox_per_unit=(40.0, 40.0, 40.0),
):
    """Valid binned kernel inputs for n_rows rows, made with numpy from
    `seed`: each row tracks in a random non-empty brick; each lane starts
    at a random point of it with a random direction, its brick exit
    computed from the brick's faces and a box exit that comes first on
    about a fifth of the lanes, the brick's majorant in inv_sig/inv_rho,
    random PCG streams, and about a tenth of the lanes not RUNNING.
    vox_per_unit (x, y, z) maps world directions to voxel space.
    Returns (row_brick, f, rng, status) on majorant's device."""
    dev = majorant.device
    rs = np.random.RandomState(seed)
    nbz, nby, nbx = majorant.shape
    major = majorant.reshape(-1).cpu().numpy()
    nonempty = np.flatnonzero(major > 0.0)
    row_brick = rs.choice(nonempty, n_rows)
    n = n_rows * TABLE_W
    lane_brick = np.repeat(row_brick, TABLE_W)
    bi = np.stack([lane_brick % nbx, lane_brick // nbx % nby,
                   lane_brick // (nbx * nby)], axis=1)  # (x, y, z)
    size = np.array(BRICK[::-1], np.float64)  # (x, y, z)
    base = bi * size
    p = base + rs.uniform(0.02, 0.98, (n, 3)) * size
    d = rs.normal(size=(n, 3))
    d = d / np.linalg.norm(d, axis=1, keepdims=True) * np.asarray(vox_per_unit)
    t = rs.uniform(0.0, 0.05, n)
    o = p - t[:, None] * d
    bound = base + (d > 0) * size
    bexit = t + np.min((bound - p) / d, axis=1)
    max_t = t + (bexit - t) * rs.uniform(0.3, 4.0, n)
    inv_sig = 1.0 / (scale * major[lane_brick])
    f = np.stack([*o.T, *d.T, t, max_t, bexit, *base.T, inv_sig,
                  inv_sig * scale]).astype(np.float32)
    status = np.where(rs.uniform(size=n) < 0.1, rs.randint(1, 5, n), RUNNING)
    state = rs.randint(0, 1 << 32, n, dtype=np.int64)
    inc = rs.randint(0, 1 << 31, n, dtype=np.int64) * 2 + 1
    return (
        torch.tensor(row_brick, dtype=torch.int64, device=dev),
        torch.tensor(f.reshape(N_F, n_rows, TABLE_W), device=dev),
        torch.tensor(np.stack([state, inc]).reshape(2, n_rows, TABLE_W),
                     device=dev),
        torch.tensor(status.reshape(n_rows, TABLE_W), dtype=torch.int32,
                     device=dev),
    )
