"""fastQ's queue-fed wavefront body as CUDA kernels (csrc/fastqbody.cu).

JAX's `render_tile` (cudavolumerenderer_tpu/models/fastq.py:83) runs its
`body` (:148) under a `lax.while_loop` (:402), so XLA compiled the whole
loop into one device program.  The port's eager body (models/fastq.py
`plain_body`, the plain version) runs an iteration as a few hundred torch
ops with a host read of the loop condition every few iterations; the
kernels run one iteration of every lane of the pool per launch, bit for bit
the eager body's on the card:

  * while the queue holds paths the iterations are lockstep (a refill ranks
    the refillable lanes of the whole pool): gated chains of `body_kernel`
    launches (the flush, the refill every 4th iteration and the rest of the
    evaluation in one launch; the iteration index is the stage's C_EVAL),
    one host read per batch (stages.BodyKernel.gated);
  * once every path is issued a refill takes nothing and the flush runs on
    every iteration, so no lane waits for another: one `drain_kernel` launch
    runs each lane to its end in registers (stages.BodyKernel.drain).

This module holds the gate (`route`), the context (`FastQContext`: the
tensors the eager body reads, and the kernels' parameter vectors read back
from them), the wrapper `run_body` (the plain version for CPU tensors, the
kernel for CUDA tensors, or it raises), the loop (`run`: stages.loop_chains
of the plain body, or the gated chains and the drain) and the bound
(`fastq_bytes`, `Traffic`).  The kernels update the state's per-lane tensors
in place unless given `out`.
"""

from __future__ import annotations

import ctypes
import dataclasses
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from . import stages
from .familybody import Prepared
from .rng import as_u32, mul32
from .stages import C_COUNT, C_EVAL, C_LMAX, C_TOTAL, DRAIN_CAP, N_CTRL
from .stages import f32 as _f32
from .stages import lane_field, own

_SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "fastqbody.cu"

# Float parameters (csrc/fastqbody.cu FP_*).
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
FP_EPSW = FP_ALB_B + 3
FP_BSIZE = FP_EPSW + 1
FP_ROUGH = FP_BSIZE + 3
FP_ETA = FP_ROUGH + 2
FP_INV_ETA = FP_ETA + 1
N_FP = FP_INV_ETA + 1

# Integer parameters (csrc/fastqbody.cu IP_*).
(IP_NPATHS, IP_NPIX, IP_TW, IP_BASE, IP_SEEDH, IP_NX, IP_NY, IP_NZ,
 IP_TWO_LEVEL, IP_TABLE, IP_ALBEDO, IP_BSDF, IP_MITSUBA, IP_RR, IP_NBX,
 IP_NBY, IP_HIX, IP_HIY, IP_HIZ, IP_IT, IP_CAP, N_IP) = range(22)

# Pointer slots (csrc/fastqbody.cu S_*): the per-lane fields in QState's
# names (the RNG's two words split), the outputs, then the rest.
LANE_FIELDS = ("o", "d", "throughput", "radiance", "pend_rad", "normal", "t",
               "max_t", "inv_sig_local", "brick_exit", "image_id", "pend_pix",
               "alive", "tracking", "rng_state", "rng_inc")
N_LANE = len(LANE_FIELDS)
_DTYPES = dict(zip(LANE_FIELDS, (torch.float32,) * 10 + (torch.int64,) * 2
                   + (torch.bool,) * 2 + (torch.int64,) * 2))
_VEC3 = LANE_FIELDS[:6]
S_OUT = N_LANE
(S_ISSUED, S_ISSUED_OUT, S_COUNTS, S_COUNTS_OUT, S_ACCUM, S_TABLE, S_BMAJ,
 S_SCRATCH, S_STATUS, S_CTRL, S_EVALS) = range(S_OUT + N_LANE,
                                              S_OUT + N_LANE + 11)
N_S = S_EVALS + 1
N_SCRATCH = 6  # csrc/fastqbody.cu SC_*
BLOCK = 256  # lanes per body_kernel block (its look-back word)

# Table layouts (IP_TABLE) and albedo modes (IP_ALBEDO): common.cuh's.
TAB_F32, TAB_ROWS = 0, 1
ALBEDO_MODES = {"const": 0, "affine": 1, "full": 2}

#: bytes of each per-lane field (the RNG's two words split), for fastq_bytes
FIELD_BYTES = dict(o=12, d=12, throughput=12, radiance=12, pend_rad=12,
                   normal=12, t=4, max_t=4, inv_sig_local=4, brick_exit=4,
                   image_id=8, pend_pix=8, alive=1, tracking=1, rng_state=8,
                   rng_inc=8)


def route(device_type: str, eager_body: bool = False) -> bool:
    """Whether fastQ's loop goes to the kernels: on the card, unless the
    caller asks for the eager body (tests and chip_smoke.py hold the
    kernels against it).  The CPU has no kernel."""
    return device_type == "cuda" and not eager_body


@dataclasses.dataclass
class FastQContext:
    """A render's body inputs besides the state: what the eager body reads
    (models/fastq.make_context computes them as the JAX body does) and,
    built at the first launch, the kernels' parameter vectors (host
    numpy)."""

    scene: object
    settings: object
    camera: object
    tile_dim: tuple
    tile_offset: torch.Tensor
    full_resolution: tuple
    n_paths: int
    seed: object
    path_id_base: object
    two_level: bool
    albedo: str  # make_fused_grid's: 'const', 'affine' or 'full' (rows)
    fused: torch.Tensor  # make_fused_grid's table
    res_minus_1: torch.Tensor
    extent: torch.Tensor
    inv_sigmat: torch.Tensor
    bm_flat: Optional[torch.Tensor] = None  # two-level: brick majorants
    brick_size: Optional[torch.Tensor] = None
    brick_hi: Optional[torch.Tensor] = None
    nbx: int = 0
    nby: int = 0
    epsw: Optional[torch.Tensor] = None
    _params: Optional[tuple] = None

    def params(self):
        """(fparams, iparams) for the kernels, read back once from the
        tensors the eager body uses.  A division by a Python scalar runs on
        the card as a multiplication by the scalar's float32 reciprocal, so
        those reciprocals are what the vector holds."""
        if self._params is None:
            self._params = _kernel_params(self)
        return self._params


def _kernel_params(ctx: FastQContext):
    scene, settings = ctx.scene, ctx.settings
    med = scene.medium
    f = np.zeros(N_FP, np.float32)
    i = np.zeros(N_IP, np.int64)
    one = np.float32(1.0)
    tw, th = ctx.tile_dim
    f[FP_TILEX:FP_TILEY + 1] = _f32(ctx.tile_offset)
    f[FP_INV_TW] = one / np.float32(tw)
    f[FP_INV_RESX] = one / np.float32(float(ctx.full_resolution[0]))
    f[FP_INV_RESY] = one / np.float32(float(ctx.full_resolution[1]))
    f[FP_CAM:FP_CAM + 12] = _f32(ctx.camera.inv_view)
    f[FP_R2VX:FP_R2VY + 1] = _f32(ctx.camera.raster_to_view)
    f[FP_BMIN:FP_BMIN + 3] = _f32(med.box_min)
    f[FP_BMAX:FP_BMAX + 3] = _f32(med.box_max)
    f[FP_EXT:FP_EXT + 3] = _f32(ctx.extent)
    f[FP_RM1:FP_RM1 + 3] = _f32(ctx.res_minus_1)
    f[FP_SCALE] = _f32(med.scale)[0]
    f[FP_INV_SIGMAT] = _f32(ctx.inv_sigmat)[0]
    f[FP_G] = _f32(med.g)[0]
    f[FP_LE:FP_LE + 3] = _f32(scene.le)
    mode = ctx.albedo
    if mode == "const":
        f[FP_ALB_B:FP_ALB_B + 3] = _f32(med.albedo.data.reshape(-1)[:3])
    elif mode == "affine":
        f[FP_ALB_A:FP_ALB_A + 3] = _f32(med.albedo_affine[0])
        f[FP_ALB_B:FP_ALB_B + 3] = _f32(med.albedo_affine[1])
    f[FP_ROUGH:FP_ROUGH + 2] = _f32(scene.bsdf.roughness)
    f[FP_ETA] = _f32(scene.bsdf.eta)[0]
    f[FP_INV_ETA] = one / f[FP_ETA]
    nz, ny, nx = med.density.data.shape
    i[IP_NPATHS], i[IP_NPIX], i[IP_TW] = ctx.n_paths, tw * th, tw
    base = ctx.path_id_base
    i[IP_BASE] = int(as_u32(base, "cpu")) if not isinstance(
        base, torch.Tensor) else int(as_u32(base).cpu())
    seed = ctx.seed if isinstance(ctx.seed, torch.Tensor) else int(ctx.seed)
    i[IP_SEEDH] = int(mul32(as_u32(seed, "cpu").cpu(), 0x9E3779B9))
    i[IP_NX], i[IP_NY], i[IP_NZ] = nx, ny, nz
    i[IP_TABLE] = TAB_ROWS if mode == "full" else TAB_F32
    i[IP_ALBEDO] = ALBEDO_MODES[mode]
    i[IP_BSDF] = int(settings.bsdf_kind == "ggx")
    i[IP_MITSUBA] = int(settings.mitsuba_comparable)
    i[IP_RR] = int(settings.russian_roulette)
    if ctx.two_level:
        i[IP_TWO_LEVEL] = 1
        f[FP_EPSW] = _f32(ctx.epsw)[0]
        f[FP_BSIZE:FP_BSIZE + 3] = _f32(ctx.brick_size)
        i[IP_NBX], i[IP_NBY] = ctx.nbx, ctx.nby
        i[IP_HIX:IP_HIZ + 1] = ctx.brick_hi.cpu().numpy()
    return f, i


# -- the plain version ---------------------------------------------------------------

def plain_body(ctx: FastQContext, s, accum, it: int, taps=None):
    """One iteration `it` of the eager body (models/fastq.plain_body), on
    any device; counted in KERNEL.plain_evals."""
    from ..models import fastq  # noqa: PLC0415

    KERNEL.plain_evals += 1
    return fastq.plain_body(ctx, s, accum, it, taps=taps)


# -- the kernels ---------------------------------------------------------------------

class FastQKernel(stages.BodyKernel):
    """The CUDA fastQ kernels, built from csrc/fastqbody.cu at first use and
    counted (stages.BodyKernel): `launches` counts body launches made now
    (a gated one may return untouched), `drain_launches` the drain's,
    `plain_evals` the plain body's evaluations, `evals` the loop's
    iterations (its trip count), kernel or plain."""

    def __init__(self):
        super().__init__("fastqbody", _SOURCE, (N_FP, N_IP, N_S, N_CTRL))
        self.reset()

    def reset(self) -> None:
        """Every count to 0."""
        self.launches = self.captured = self.drain_launches = self.reads = 0
        self.enqueue_s = 0.0
        self.evals = self.plain_evals = 0

    def prepare(self, ctx: FastQContext, s, accum, counts, *, out=None,
                issued_out=None, counts_out=None, it: int = 0, ctrl=None,
                evals=None, cap: int = 0) -> Prepared:
        """The checked arguments of launches on the state `s` (a QState) that
        write `out`'s per-lane fields (s's when None), read the (3,) float32
        `counts` (n_rays, n_iters, n_busy) and write them to `counts_out`,
        and paths_issued from s to `issued_out` (in place when None);
        evaluation `it`, or gated on `ctrl` when given; `evals` the drain's
        per-evaluation counts (2 * cap)."""
        fparams, iparams0 = ctx.params()
        out = s if out is None else out
        dev = s.alive.device
        width = s.alive.shape[0]
        for name in LANE_FIELDS:
            x, y = lane_field(s, name), lane_field(out, name)
            _check(name, x, width, dev)
            if y is not x:
                _check(name, y, width, dev)
                if stages.overlaps(x, y):
                    raise ValueError(
                        f"fastqbody: out.{name} overlaps the input partly")
        for name, x in (("accum", accum), ("table", ctx.fused),
                        ("brick majorants", ctx.bm_flat)):
            if x is not None and (x.device != dev or x.dtype != torch.float32
                                  or not x.is_contiguous()):
                raise ValueError(f"fastqbody: {name} must be contiguous "
                                 f"float32 on {dev}")
        if accum.ndim != 2 or accum.shape[1] != 3:
            raise ValueError("fastqbody: accum must be (pixels, 3)")
        for name, x in (("counts", counts), ("counts_out", counts_out)):
            if x is not None and (x.device != dev or x.dtype != torch.float32
                                  or tuple(x.shape) != (3,)
                                  or not x.is_contiguous()):
                raise ValueError(f"fastqbody: {name} must be a contiguous "
                                 f"(3,) float32 tensor on {dev}")
        for name, x in (("paths_issued", s.paths_issued),
                        ("issued_out", issued_out)):
            if x is not None and (x.device != dev or x.dtype != torch.int64
                                  or x.numel() != 1):
                raise ValueError(f"fastqbody: {name} must be a 0-d int64 "
                                 f"tensor on {dev}")
        iparams = iparams0.copy()
        iparams[IP_IT], iparams[IP_CAP] = it, cap
        ptrs = [0] * N_S
        for k, name in enumerate(LANE_FIELDS):
            ptrs[k] = lane_field(s, name).data_ptr()
            ptrs[S_OUT + k] = lane_field(out, name).data_ptr()
        nblocks = -(-width // BLOCK)
        for slot, x in (
                (S_ISSUED, s.paths_issued),
                (S_ISSUED_OUT, s.paths_issued if issued_out is None
                 else issued_out),
                (S_COUNTS, counts),
                (S_COUNTS_OUT, counts if counts_out is None else counts_out),
                (S_ACCUM, accum), (S_TABLE, ctx.fused), (S_BMAJ, ctx.bm_flat),
                (S_SCRATCH, self.zeros("scratch", N_SCRATCH, torch.int64,
                                       dev)),
                (S_STATUS, self.zeros("status", nblocks, torch.int64, dev)),
                (S_CTRL, ctrl), (S_EVALS, evals)):
            ptrs[slot] = 0 if x is None else x.data_ptr()
        addresses = (ctypes.c_void_p * N_S)(*ptrs)
        return Prepared("body", self.args(fparams, iparams, addresses, width),
                        (fparams, iparams, addresses))

    def evaluate(self, ctx: FastQContext, s, accum, it: int, out=None):
        """Iteration `it` of every lane of `s` (a QState): the new state (its
        per-lane tensors `out`'s, or s's, updated in place; fresh counters
        and paths_issued); the flush adds into `accum` in place."""
        dev = s.alive.device
        out = s if out is None else out
        counts = torch.stack([s.n_rays, s.n_iters, s.n_busy])
        counts_out = torch.empty(3, dtype=torch.float32, device=dev)
        issued = torch.empty((), dtype=torch.int64, device=dev)
        prep = self.prepare(ctx, s, accum, counts, out=out, issued_out=issued,
                            counts_out=counts_out, it=it)
        self.launch_one(prep.args, dev)
        return out._replace(paths_issued=issued, n_rays=counts_out[0],
                            n_iters=counts_out[1], n_busy=counts_out[2])

    def queue_stage(self, ctx: FastQContext, s, accum, counts) -> int:
        """The iterations from 0 while the queue holds paths, in gated chains
        (stages.BodyKernel.gated): the state's per-lane tensors, its
        paths_issued and `counts` (n_rays, n_iters, n_busy) updated in
        place.  Returns the iteration at which every path is issued."""
        dev = s.alive.device
        ctrl = torch.zeros(N_CTRL, dtype=torch.int64, device=dev)
        ctrl[C_COUNT] = ctx.n_paths - s.paths_issued
        prep = self.prepare(ctx, s, accum, counts, ctrl=ctrl)
        return self.gated(prep.args, ctrl, 0, 1, dev)

    def drain_stage(self, ctx: FastQContext, s, accum, counts, e0: int,
                    cap: int = DRAIN_CAP) -> list:
        """The iterations from e0, once every path is issued, drained
        (stages.BodyKernel.drain): the state's per-lane tensors and `counts`
        updated in place.  Returns the last launch's control words
        (C_TOTAL: the loop's trip count)."""
        dev = s.alive.device
        ctrl = torch.zeros(N_CTRL, dtype=torch.int64, device=dev)
        ctrl[C_EVAL] = ctrl[C_LMAX] = e0
        evals = self.zeros("evals", 2 * cap, torch.int32, dev)
        prep = self.prepare(ctx, s, accum, counts, ctrl=ctrl, evals=evals,
                            cap=cap)
        return self.drain(prep.args, (), ctrl, dev)

    def render(self, ctx: FastQContext, s, accum, cap: int = DRAIN_CAP):
        """render_tile's loop from iteration 0 on the state `s` (updated in
        place): gated chains while the queue holds paths, then the drain.
        Returns the state with fresh counters; `evals` adds the loop's
        iterations."""
        counts = torch.stack([s.n_rays, s.n_iters, s.n_busy])
        e0 = self.queue_stage(ctx, s, accum, counts)
        self.evals += self.drain_stage(ctx, s, accum, counts, e0, cap)[C_TOTAL]
        return s._replace(n_rays=counts[0], n_iters=counts[1],
                          n_busy=counts[2])


def _check(name, x, width, dev):
    shape = (width, 3) if name in _VEC3 else (width,)
    stages.check_lane("fastqbody", name, x, _DTYPES[name], shape, dev)


KERNEL = FastQKernel()


def run_body(ctx: FastQContext, s, accum, it: int, out=None):
    """Iteration `it` of the pool `s`: the plain version for CPU tensors, the
    CUDA kernel for CUDA tensors (updating s's per-lane tensors in place, or
    writing `out`'s).  Returns the new state; the flush adds into `accum`."""
    dev = s.alive.device
    if dev.type == "cpu":
        return plain_body(ctx, s, accum, it)
    if dev.type == "cuda":
        return KERNEL.evaluate(ctx, s, accum, it, out=out)
    raise ValueError(f"fastqbody: no kernel for device {dev}")


def pending_count(s) -> int:
    """The lanes with a path in flight or a pending result (one host
    read)."""
    return int(torch.count_nonzero(s.alive | (s.pend_pix >= 0)))


def run(ctx: FastQContext, s, accum, kernel: bool, check_every: int):
    """render_tile's loop (iterations while a lane is alive or pending or a
    path unissued): the gated chains and the drain when `kernel`, else
    stages.loop_chains of the plain body, chains of check_every iterations
    while paths are unissued and then while lanes are pending (an iteration
    after the loop's end changes nothing).  Returns the state; KERNEL.evals
    adds the loop's iterations."""
    if kernel:
        return KERNEL.render(ctx, own(s), accum)
    it = 0

    def body(x):
        nonlocal it
        x = plain_body(ctx, x, accum, it)
        it += 1
        return x, None

    s, _ = stages.loop_chains(KERNEL, s, lambda x: ctx.n_paths - int(
        x.paths_issued), body, 0, check_every)
    s, _ = stages.loop_chains(KERNEL, s, pending_count, body, 0, check_every)
    KERNEL.evals += int(s.n_iters)
    KERNEL.reads += 1
    return s


# -- the bound -----------------------------------------------------------------

class Traffic(stages.Traffic):
    """fastq_bytes over evaluations given in order, added one at a time."""

    def __init__(self, ctx: FastQContext):
        rows = ctx.albedo == "full"
        super().__init__(FIELD_BYTES, {"tap": 16 if rows else 4, "brick": 4,
                                       "accum": 24})


def fastq_bytes(ctx: FastQContext, taps) -> int:
    """The least bytes the evaluations whose `taps` are given move (the list
    the eager body fills: ("state", stages.lane_traffic), ("tap", flat table
    indices), ("brick", brick majorants) and ("accum", flushed pixels) of the
    lanes that read or add them).  Each lane reads the fields its evaluation
    reads (a lane at the fixed point its alive flag and pending pixel) and
    writes the fields it changes; the distinct table entries (4 B, a 'full'
    row 16 B) and brick majorants are read once, each flushed pixel read and
    written once (24 B).  Given every evaluation of a drain, in order, the
    drain's."""
    return Traffic(ctx).add(taps).total()
