"""fastSK's wavefront body as one CUDA kernel (csrc/fastbody.cu).

JAX's `render_tile` (cudavolumerenderer_tpu/models/fast.py:744) runs its
`body` under a `lax.while_loop`, so XLA compiled each cascade stage into
one device program.  The port's eager body (models/fast.py, render_tile's
`body`) runs it as ~1,000 torch launches per evaluation; the kernel runs
one evaluation of every lane of a pool in one launch, bit for bit the
eager body's on the card, for `spec_k == 1` and `defer_ggx == 0` (the
speculative tail steps and the deferred GGX flush stay eager: `route`).

This module holds the gate (`route`), the kernel's parameter vectors
(`make_context`, `stage_context`), the wrapper `run_body` (the plain
version, the eager body, for CPU tensors; the kernel for CUDA tensors, or
it raises) and the bound (`body_bytes`).  The kernel updates the state's
per-lane tensors in place unless it is given `out`, and returns fresh
0-d counters (n_rays, n_rows, n_busy) and the pool's pending count.
"""

from __future__ import annotations

import ctypes
import dataclasses
import time
from pathlib import Path
from typing import Callable, Optional

import numpy as np
import torch

from .rng import M32, as_u32, mul32

_SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "fastbody.cu"

# Float parameters (csrc/fastbody.cu FP_*).
FP_TILEX, FP_TILEY, FP_INV_TW, FP_INV_RESX, FP_INV_RESY = range(5)
FP_CAM = 5  # the camera's (3, 4) inv_view, row-major
FP_R2VX = FP_CAM + 12
FP_R2VY = FP_R2VX + 1
FP_BMIN = FP_R2VY + 1
FP_BMAX = FP_BMIN + 3
FP_EXT = FP_BMAX + 3
FP_RM1 = FP_EXT + 3
FP_SCALE = FP_RM1 + 3
FP_INV_SIGMAT = FP_SCALE + 1
FP_G = FP_INV_SIGMAT + 1
FP_LE = FP_G + 1
FP_ALB_A = FP_LE + 3
FP_ALB_B = FP_ALB_A + 3
FP_QSCALE = FP_ALB_B + 3
FP_EPSW = FP_QSCALE + 1
FP_BSIZE = FP_EPSW + 1
FP_ROUGH = FP_BSIZE + 3
FP_ETA = FP_ROUGH + 2
FP_INV_ETA = FP_ETA + 1
N_FP = FP_INV_ETA + 1

# Integer parameters (csrc/fastbody.cu IP_*).
(IP_SPP, IP_M, IP_NPIX, IP_TW, IP_MULTI, IP_BASE, IP_SEEDH, IP_NX, IP_NY,
 IP_NZ, IP_TWO_LEVEL, IP_TABLE, IP_BITS, IP_BRICK_MAJOR, IP_ALBEDO,
 IP_ALB_STRIDE, IP_BSDF, IP_MITSUBA, IP_RR, IP_MAXPATH, IP_NBX, IP_NBY,
 IP_HIX, IP_HIY, IP_HIZ, IP_THRESH, IP_CHAIN, IP_CAP, N_IP) = range(29)

# Pointer slots (csrc/fastbody.cu S_*): the per-lane fields the body
# updates, in FastState's names, then the rest.
LANE_FIELDS = ("o", "d", "throughput", "accum", "normal", "t", "max_t",
               "brick_exit", "inv_sig_local", "samples_done", "bounce",
               "alive", "tracking", "rng_state", "rng_inc")
N_LANE = len(LANE_FIELDS)
_DTYPES = dict(zip(LANE_FIELDS, (torch.float32,) * 9 + (torch.int64,) * 2
                   + (torch.bool,) * 2 + (torch.int64,) * 2),
               pix=torch.int64, slot=torch.int64)
S_PIX = N_LANE
S_SLOT, S_NRAYS, S_NROWS, S_NBUSY = S_PIX + 1, S_PIX + 2, S_PIX + 3, S_PIX + 4
S_OUT = S_NBUSY + 1
S_COUNTS = S_OUT + N_LANE
S_PENDING, S_SCRATCH = S_COUNTS + 1, S_COUNTS + 2
(S_TABLE, S_ALB_ROWS, S_BTAB, S_TILE_OFF, S_BASES, S_CTRL,
 S_EVALS) = range(S_SCRATCH + 1, S_SCRATCH + 8)
N_S = S_EVALS + 1

# A stage's control words (csrc/fastbody.cu C_*, int64).
(C_EVAL, C_PEND, C_LMAX, C_LEFT_ACC, C_JMAX, C_TICKET, C_LEFT, C_TOTAL,
 N_CTRL) = range(9)

#: evaluations enqueued per host read in a gated stage (rounded up to a
#: whole number of chains)
GATED_BATCH = 32
#: the drain's evaluations per lane and launch (its per-evaluation count
#: arrays hold this many); a lane at the cap is stored, and the host
#: launches again
DRAIN_CAP = 8192
#: the drain's threads per block: a narrow pool in small blocks spreads
#: over the SMs (32, 64, 128 and 256 time alike on config 2's last pool,
#: chip_smoke.py phase 22)
DRAIN_THREADS = 32

# Table and albedo modes (IP_TABLE, IP_ALBEDO).
TAB_F32, TAB_ROWS, TAB_PACKED = range(3)
ALBEDO_MODES = {"const": 0, "affine": 1, "full": 2, "split": 3}

#: bytes of one lane's state the kernel reads (o, d, throughput, accum,
#: normal; t, max_t, brick_exit, inv_sig_local; pix, slot, samples_done,
#: bounce; alive, tracking; the RNG's two words) and writes (all but pix
#: and slot)
LANE_READ_BYTES = 15 * 4 + 4 * 4 + 4 * 8 + 2 + 2 * 8
LANE_WRITTEN_BYTES = LANE_READ_BYTES - 2 * 8


def route(device_type: str, spec_k: int, defer_ggx: int,
          eager_body: bool = False) -> bool:
    """Whether a stage's body evaluations go to the kernel: on the card,
    for spec_k == 1 and defer_ggx == 0, unless the caller asks for the
    eager body (tests and chip_smoke.py hold the kernel against it).  The
    speculative steps (tail_spec > 1) and the deferred GGX flush stay
    eager; so does the CPU, which has no kernel."""
    return (device_type == "cuda" and spec_k == 1 and defer_ggx == 0
            and not eager_body)


def stage_mode(device_type: str, spec_k: int, defer_ggx: int, thresh: int,
               eager_body: bool = False) -> str:
    """How a cascade stage runs: "eager" where `route` keeps the eager
    body, else by the stage's exit threshold alone: "drain" at 0 (the last
    stage without the tail kernel), "gated" above it."""
    if not route(device_type, spec_k, defer_ggx, eager_body):
        return "eager"
    return "drain" if thresh == 0 else "gated"


@dataclasses.dataclass
class BodyContext:
    """One stage's kernel inputs besides the state: the parameter
    vectors (host numpy), the read-only tensors (None where a mode reads
    none) and the eager body with the stage's keywords (the plain
    version; it takes an optional `taps` list, see body_bytes)."""

    fparams: np.ndarray  # (N_FP,) float32
    iparams: np.ndarray  # (N_IP,) int64
    table: torch.Tensor
    albedo_rows: Optional[torch.Tensor]
    brick_tab: Optional[torch.Tensor]
    tile_offset: Optional[torch.Tensor]  # (T, 2), multi-tile mode
    bases: Optional[torch.Tensor]  # (T,) int64, multi-tile mode
    plain: Optional[Callable] = None


def _f32(x) -> np.ndarray:
    """A tensor's (or number's) float32 values on the host."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", torch.float32).numpy().reshape(-1)
    return np.asarray(x, np.float32).reshape(-1)


def make_context(scene, camera, settings, full_resolution, tile_dim,
                 tile_offset, path_id_base, seed, *, spp_per_lane: int,
                 m: int, n_pix_tile: int, res_minus_1, extent, inv_sigmat,
                 epsw, two_level: bool, table: torch.Tensor, table_bits: int,
                 brick_major: bool, albedo_mode: str,
                 albedo_rows: Optional[torch.Tensor]) -> BodyContext:
    """The kernel's parameters from the values render_tile computes (the
    same tensors, read back to the host once per render): the brick
    fields stay 0 until `stage_context` fills them.  A division by a
    Python scalar runs on the card as a multiplication by the scalar's
    float32 reciprocal, so those reciprocals are what the vector holds."""
    med = scene.medium
    nz, ny, nx = med.density.data.shape
    tw = int(tile_dim[0])
    multi = tile_offset.ndim == 2
    f = np.zeros(N_FP, np.float32)
    i = np.zeros(N_IP, np.int64)
    one = np.float32(1.0)
    if not multi:
        f[FP_TILEX:FP_TILEY + 1] = _f32(tile_offset)
    f[FP_INV_TW] = one / np.float32(tw)
    f[FP_INV_RESX] = one / np.float32(float(full_resolution[0]))
    f[FP_INV_RESY] = one / np.float32(float(full_resolution[1]))
    f[FP_CAM:FP_CAM + 12] = _f32(camera.inv_view)
    f[FP_R2VX:FP_R2VY + 1] = _f32(camera.raster_to_view)
    f[FP_BMIN:FP_BMIN + 3] = _f32(med.box_min)
    f[FP_BMAX:FP_BMAX + 3] = _f32(med.box_max)
    f[FP_EXT:FP_EXT + 3] = _f32(extent)
    f[FP_RM1:FP_RM1 + 3] = _f32(res_minus_1)
    f[FP_SCALE] = _f32(med.scale)[0]
    f[FP_INV_SIGMAT] = _f32(inv_sigmat)[0]
    f[FP_G] = _f32(med.g)[0]
    f[FP_LE:FP_LE + 3] = _f32(scene.le)
    if albedo_mode == "const":
        f[FP_ALB_B:FP_ALB_B + 3] = _f32(med.albedo.data.reshape(-1)[:3])
    elif albedo_mode == "affine":
        f[FP_ALB_A:FP_ALB_A + 3] = _f32(med.albedo_affine[0])
        f[FP_ALB_B:FP_ALB_B + 3] = _f32(med.albedo_affine[1])
    if table_bits in (8, 4) and albedo_mode != "full":
        # packed_take's dequantizing factor, as the eager op computes it
        f[FP_QSCALE] = _f32(med.max_density / float((1 << table_bits) - 1))[0]
    f[FP_EPSW] = _f32(epsw)[0]
    f[FP_ROUGH:FP_ROUGH + 2] = _f32(scene.bsdf.roughness)
    f[FP_ETA] = _f32(scene.bsdf.eta)[0]
    f[FP_INV_ETA] = one / f[FP_ETA]

    i[IP_SPP], i[IP_M], i[IP_NPIX], i[IP_TW] = spp_per_lane, m, n_pix_tile, tw
    i[IP_MULTI] = int(multi)
    if not multi:
        i[IP_BASE] = int(path_id_base) & M32
    seed_u = as_u32(seed if isinstance(seed, torch.Tensor) else int(seed))
    i[IP_SEEDH] = int(mul32(seed_u.cpu(), 0x9E3779B9))
    i[IP_NX], i[IP_NY], i[IP_NZ] = nx, ny, nz
    i[IP_TWO_LEVEL] = int(two_level)
    if albedo_mode == "full":
        i[IP_TABLE] = TAB_ROWS
    elif table_bits in (8, 4):
        i[IP_TABLE], i[IP_BITS] = TAB_PACKED, table_bits
    i[IP_BRICK_MAJOR] = int(brick_major)
    i[IP_ALBEDO] = ALBEDO_MODES[albedo_mode]
    if albedo_rows is not None:
        i[IP_ALB_STRIDE] = albedo_rows.shape[-1]
    i[IP_BSDF] = int(settings.bsdf_kind == "ggx")
    i[IP_MITSUBA] = int(settings.mitsuba_comparable)
    i[IP_RR] = int(settings.russian_roulette)
    i[IP_MAXPATH] = settings.max_path_length
    dev = table.device
    return BodyContext(
        fparams=f, iparams=i, table=table, albedo_rows=albedo_rows,
        brick_tab=None,
        tile_offset=(tile_offset.to(dev, torch.float32).contiguous()
                     if multi else None),
        bases=((torch.as_tensor(path_id_base, dtype=torch.int64,
                                device=dev) & M32).contiguous()
               if multi else None),
    )


def stage_context(ctx: BodyContext, bt: Optional[dict], single_level: bool,
                  plain: Callable) -> BodyContext:
    """`ctx` for one stage: two-level with the brick table `bt` (the
    coarse or the tail's fine one) unless single_level, and the eager body
    with the stage's keywords."""
    f, i = ctx.fparams.copy(), ctx.iparams.copy()
    two = bool(i[IP_TWO_LEVEL]) and not single_level and bt is not None
    i[IP_TWO_LEVEL] = int(two)
    brick_tab = None
    if two:
        f[FP_BSIZE:FP_BSIZE + 3] = _f32(bt["size"])
        i[IP_HIX:IP_HIZ + 1] = bt["hi"].cpu().numpy()
        i[IP_NBX], i[IP_NBY] = bt["nbx"], bt["nby"]
        brick_tab = bt["tab"].contiguous()
    return dataclasses.replace(ctx, fparams=f, iparams=i, brick_tab=brick_tab,
                               plain=plain)


class FastBodyKernel:
    """The CUDA body kernels: built from csrc/fastbody.cu at first use,
    launched through their C entry points, and counted.  `launches` counts
    body_kernel launches made now (one evaluation each, or a gated one
    that may return untouched); a launch recorded into a CUDA graph being
    captured counts in `captured` instead.  `drain_launches` counts
    drain_kernel launches, `reads` the host's reads of a stage's control
    words or pending count (loop_stage's too), `enqueue_s` the host's
    seconds in gated stages' enqueue loops, and `last_drain` holds the
    last drain's longest lane L, its evaluations E, launches and block
    size."""

    def __init__(self):
        self.launches = 0  # CUDA launches; the plain version is not counted
        self.captured = 0
        self.drain_launches = 0
        self.reads = 0
        self.enqueue_s = 0.0  # host seconds in gated stages' enqueue loops
        self.last_drain = None
        self._built = None
        self._scratch = {}  # device -> (4,) int64 zeros the kernel reuses
        self._evals = {}  # (device, cap) -> (2 cap,) int32 zeros (the drain)

    def library(self):
        """Build (or reuse) and load the kernel library; returns the
        utils.cuda_build.BuiltLibrary."""
        if self._built is None:
            from ..utils import cuda_build  # noqa: PLC0415

            built = cuda_build.build_library(_SOURCE)
            args = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                    ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
            built.lib.fastbody_launch.argtypes = args + [ctypes.c_void_p]
            built.lib.fastbody_drain.argtypes = args + [ctypes.c_int,
                                                        ctypes.c_void_p]
            built.lib.fastbody_launch.restype = ctypes.c_int
            built.lib.fastbody_drain.restype = ctypes.c_int
            sizes = (ctypes.c_int * 4)()
            built.lib.fastbody_layout(sizes)
            if tuple(sizes) != (N_FP, N_IP, N_S, N_CTRL):
                raise RuntimeError(
                    f"fastbody: csrc/fastbody.cu's layout {tuple(sizes)} is "
                    f"not ops/fastbody.py's {(N_FP, N_IP, N_S, N_CTRL)}")
            self._built = built
        return self._built

    def scratch(self, dev) -> torch.Tensor:
        if dev not in self._scratch:
            self._scratch[dev] = torch.zeros(4, dtype=torch.int64, device=dev)
        return self._scratch[dev]

    def _pointers(self, ctx: BodyContext, s, out, counts, pending, ctrl=None,
                  evals=None):
        """The checked pointer array of launches on `s` that write `out`'s
        per-lane tensors, read s's counters (n_rays, n_rows, n_busy), write
        the new ones to the (3,) float32 `counts` and the pending count to
        `pending` (a 0-d int64 tensor, or None)."""
        width = s.alive.shape[0]
        dev = s.alive.device
        fields = [_lane_field(s, name) for name in LANE_FIELDS]
        outs = [_lane_field(out, name) for name in LANE_FIELDS]
        for name, x, y in zip(LANE_FIELDS, fields, outs):
            _check(name, x, width, dev)
            if y is not x:
                _check(name, y, width, dev)
                if _overlaps(x, y):
                    raise ValueError(
                        f"fastbody: out.{name} overlaps the input partly")
        for name in ("pix", "slot"):
            _check(name, getattr(s, name), width, dev)
        for name in ("n_rays", "n_rows", "n_busy"):
            x = getattr(s, name)
            if x.device != dev or x.dtype != torch.float32 or x.ndim != 0:
                raise ValueError(f"fastbody: {name} must be a 0-d float32 "
                                 f"tensor on {dev}")
        for name in ("table", "albedo_rows", "brick_tab", "tile_offset",
                     "bases"):
            x = getattr(ctx, name)
            if x is not None and (x.device != dev or not x.is_contiguous()):
                raise ValueError(f"fastbody: {name} must be contiguous on "
                                 f"{dev}")
        ptrs = [0] * N_S
        for k, x in enumerate(fields):
            ptrs[k] = x.data_ptr()
        for k, x in enumerate(outs):
            ptrs[S_OUT + k] = x.data_ptr()
        ptrs[S_PIX], ptrs[S_SLOT] = s.pix.data_ptr(), s.slot.data_ptr()
        ptrs[S_NRAYS] = s.n_rays.data_ptr()
        ptrs[S_NROWS] = s.n_rows.data_ptr()
        ptrs[S_NBUSY] = s.n_busy.data_ptr()
        ptrs[S_COUNTS] = counts.data_ptr()
        ptrs[S_PENDING] = 0 if pending is None else pending.data_ptr()
        ptrs[S_SCRATCH] = self.scratch(dev).data_ptr()
        for slot_, x in ((S_TABLE, ctx.table), (S_ALB_ROWS, ctx.albedo_rows),
                         (S_BTAB, ctx.brick_tab), (S_TILE_OFF, ctx.tile_offset),
                         (S_BASES, ctx.bases), (S_CTRL, ctrl),
                         (S_EVALS, evals)):
            ptrs[slot_] = 0 if x is None else x.data_ptr()
        return (ctypes.c_void_p * N_S)(*ptrs)

    def launch(self, ctx: BodyContext, s, out=None):
        """One body evaluation of every lane of `s` (a FastState): the new
        state (its per-lane tensors `out`'s, or `s`'s, updated in place)
        and the pool's pending count as a 0-d int64 tensor."""
        dev = s.alive.device
        out = s if out is None else out
        counts = torch.empty(3, dtype=torch.float32, device=dev)
        pending = torch.empty((), dtype=torch.int64, device=dev)
        addresses = self._pointers(ctx, s, out, counts, pending)
        fn = self.library().lib.fastbody_launch
        with torch.cuda.device(dev):
            err = fn(ctx.fparams.ctypes.data, N_FP, ctx.iparams.ctypes.data,
                     N_IP, ctypes.addressof(addresses), N_S, s.alive.shape[0],
                     torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise RuntimeError(f"fastbody launch failed: CUDA error {err}")
        if torch.cuda.is_current_stream_capturing():
            self.captured += 1
        else:
            self.launches += 1
        new = out._replace(pix=s.pix, slot=s.slot, pend_b=s.pend_b,
                           n_rays=counts[0], n_rows=counts[1],
                           n_busy=counts[2])
        return new, pending

    def _read(self, ctrl: torch.Tensor) -> list:
        self.reads += 1
        return ctrl.tolist()

    def gated(self, ctx: BodyContext, s, thresh: int, k_chain: int,
              batch: int = GATED_BATCH):
        """A stage whose loop exits at a chain boundary once the pending
        count is at most `thresh` (> 0): the state's per-lane tensors
        updated in place, its counters fresh.  The launch is prepared once;
        the host enqueues whole chains `batch` evaluations at a time and
        reads the control words once per batch (and once at the start)."""
        dev = s.alive.device
        width = s.alive.shape[0]
        spp = int(ctx.iparams[IP_SPP])
        counts = torch.stack([s.n_rays, s.n_rows, s.n_busy])
        s = s._replace(n_rays=counts[0], n_rows=counts[1], n_busy=counts[2])
        ctrl = torch.zeros(N_CTRL, dtype=torch.int64, device=dev)
        ctrl[C_PEND] = torch.count_nonzero(s.alive | (s.samples_done < spp))
        iparams = ctx.iparams.copy()
        iparams[IP_THRESH], iparams[IP_CHAIN] = thresh, k_chain
        addresses = self._pointers(ctx, s, s, counts, ctrl[C_PEND], ctrl)
        n = k_chain * -(-batch // k_chain)
        fn = self.library().lib.fastbody_launch
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("fastbody: a gated stage reads the card; it "
                               "cannot be captured")
        args = (ctx.fparams.ctypes.data, N_FP, iparams.ctypes.data, N_IP,
                ctypes.addressof(addresses), N_S, width,
                torch.cuda.current_stream(dev).cuda_stream)
        with torch.cuda.device(dev):
            while True:
                e, pend = self._read(ctrl[:C_PEND + 1])
                if e % k_chain == 0 and pend <= thresh:
                    return s
                t0 = time.perf_counter()
                for _ in range(n):
                    err = fn(*args)
                    if err != 0:
                        raise RuntimeError(
                            f"fastbody launch failed: CUDA error {err}")
                    self.launches += 1
                self.enqueue_s += time.perf_counter() - t0

    def drain(self, ctx: BodyContext, s, k_chain: int, cap: int = DRAIN_CAP,
              threads: int = DRAIN_THREADS):
        """The last stage without the tail kernel (its loop exits at a
        pending count of 0): each lane runs to its end, `cap` evaluations
        per launch at most, in blocks of `threads` (32, 64, 128 or 256);
        one host read per launch.  The state's per-lane tensors are updated
        in place, its counters fresh."""
        dev = s.alive.device
        width = s.alive.shape[0]
        counts = torch.stack([s.n_rays, s.n_rows, s.n_busy])
        s = s._replace(n_rays=counts[0], n_rows=counts[1], n_busy=counts[2])
        ctrl = torch.zeros(N_CTRL, dtype=torch.int64, device=dev)
        if (dev, cap) not in self._evals:
            self._evals[dev, cap] = torch.zeros(2 * cap, dtype=torch.int32,
                                                device=dev)
        iparams = ctx.iparams.copy()
        iparams[IP_CHAIN], iparams[IP_CAP] = k_chain, cap
        addresses = self._pointers(ctx, s, s, counts, None, ctrl,
                                   self._evals[dev, cap])
        fn = self.library().lib.fastbody_drain
        launches = 0
        while True:
            with torch.cuda.device(dev):
                err = fn(ctx.fparams.ctypes.data, N_FP, iparams.ctypes.data,
                         N_IP, ctypes.addressof(addresses), N_S, width,
                         threads, torch.cuda.current_stream(dev).cuda_stream)
            if err != 0:
                raise RuntimeError(f"fastbody drain failed: CUDA error {err}")
            self.drain_launches += 1
            launches += 1
            words = self._read(ctrl)
            if words[C_LEFT] == 0:
                break
        self.last_drain = {"L": words[C_LMAX], "E": words[C_TOTAL],
                           "launches": launches, "threads": threads}
        return s


def _lane_field(s, name: str) -> torch.Tensor:
    if name == "rng_state":
        return s.rng.state
    if name == "rng_inc":
        return s.rng.inc
    return getattr(s, name)


def _check(name, x, width, dev):
    want = _DTYPES[name]
    shape = (width, 3) if name in LANE_FIELDS[:5] else (width,)
    if (x.device != dev or x.dtype != want or tuple(x.shape) != shape
            or not x.is_contiguous()):
        raise ValueError(
            f"fastbody: {name} must be contiguous {want} {shape} on {dev}, "
            f"got {x.dtype} {tuple(x.shape)} on {x.device}")


def _overlaps(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Whether two tensors share memory without being the same buffer
    (in place is the same buffer; anything else must not overlap, as a
    lane's thread reads all its fields before it writes any)."""
    a0, b0 = a.data_ptr(), b.data_ptr()
    if a0 == b0:
        return False
    a1 = a0 + a.numel() * a.element_size()
    b1 = b0 + b.numel() * b.element_size()
    return a0 < b1 and b0 < a1


KERNEL = FastBodyKernel()


def run_body(ctx: BodyContext, s, out=None):
    """One body evaluation of the pool `s`: the plain version (the eager
    body) for CPU tensors, the CUDA kernel for CUDA tensors.  Returns the
    new state and the pool's pending count as a 0-d tensor, or None when
    the plain version ran (the caller counts)."""
    dev = s.alive.device
    if dev.type == "cpu":
        return ctx.plain(s), None
    if dev.type == "cuda":
        return KERNEL.launch(ctx, s, out)
    raise ValueError(f"fastbody: no kernel for device {dev}")


def pending_count(s, spp: int) -> int:
    """The pool's pending lanes (a path in flight or samples left), read
    to the host."""
    return int(torch.count_nonzero(s.alive | (s.samples_done < spp)))


def loop_stage(ctx: BodyContext, s, thresh: int, k_chain: int):
    """The plain version of a stage: chains of k_chain `run_body`
    evaluations while the pending count exceeds `thresh`, the count read
    at each chain's end (the kernel's, or counted here on the CPU; each
    read counts in KERNEL.reads)."""
    spp = int(ctx.iparams[IP_SPP])
    pending = None  # the kernel's count of the last evaluation
    while True:
        n = pending_count(s, spp) if pending is None else int(pending)
        KERNEL.reads += 1
        if n <= thresh:
            return s
        for _ in range(k_chain):
            s, pending = run_body(ctx, s)


def run_stage(ctx: BodyContext, s, thresh: int, k_chain: int, last: bool):
    """One cascade stage of render_tile: the state once the loop of body
    evaluations would exit (the pending count at most `thresh` at a chain
    boundary), n_rows telling the evaluations.  On the CPU `loop_stage`;
    on the card the drain for a threshold of 0 (only the last stage has
    it) and gated chains above it, both equal to `loop_stage` bit for bit.
    The kernels update the state's per-lane tensors in place."""
    if s.alive.device.type != "cuda":  # another device raises in run_body
        return loop_stage(ctx, s, thresh, k_chain)
    if thresh == 0:
        if not last:
            raise ValueError("fastbody: only the last stage drains")
        return KERNEL.drain(ctx, s, k_chain)
    return KERNEL.gated(ctx, s, thresh, k_chain)


def body_bytes(ctx: BodyContext, width: int, taps) -> int:
    """The least bytes one evaluation of a width-lane pool moves: each
    lane's state read once and written once, and the distinct table
    entries its taps read, counted from the plain version's `taps` (a
    list the eager body fills with ("tap", flat indices) and ("brick",
    brick rows) of the lanes that read them).  Given the taps of every
    evaluation of a drained stage, the drain's: it reads and writes each
    lane's state once however many evaluations the lane runs."""
    kind = int(ctx.iparams[IP_TABLE])
    tap_idx = [x for k, x in taps if k == "tap"]
    bricks = [x for k, x in taps if k == "brick"]
    n = width * (LANE_READ_BYTES + LANE_WRITTEN_BYTES)
    if tap_idx:
        j = torch.cat(tap_idx)
        if kind == TAB_PACKED:
            per = 32 // int(ctx.iparams[IP_BITS])
            j = ((j >> 7) // per) * 128 + (j & 127)  # the words read
        n += torch.unique(j).numel() * (16 if kind == TAB_ROWS else 4)
    if bricks:
        n += torch.unique(torch.cat(bricks)).numel() * 8
    return n
