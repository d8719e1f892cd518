"""render_diff's fused two-level replay body as one CUDA kernel
(csrc/replaybody.cu).

JAX's `_replay_2l_fused` (cudavolumerenderer_tpu/models/differentiable.py:565)
runs its `body` (:623) under a `lax.while_loop` per cascade stage, so XLA
compiled each stage into one device program.  The port's eager body
(models/differentiable.py, `_replay_body`) runs ~800 torch launches per
evaluation; the kernel runs one evaluation of every lane of a pool in one
launch, bit for bit the eager body's on the card, the primal and pass B
(the backward's adjoint scatter) alike.

This module holds the kernel's parameter vectors (`make_context`), the
wrapper `run_body` (the plain version, the eager body, for CPU tensors; the
kernel for CUDA tensors, or it raises), the stage runners (`loop_stage`,
the plain loop of a stage; `run_stage`, ops/stages.py's gated chains or
drain on the card) and the bound (`replay_bytes`).  The kernel updates the
pool's per-lane tensors in place unless it is given `out`.

Pass B adds its adjoints with atomics, unless
torch.are_deterministic_algorithms_enabled(): then each evaluation is one
launch that writes each lane's (index, value) pairs, and the wrapper adds
them with index_add_ (and torch.sum for a constant albedo) as the eager
body does, so the cotangents are the eager body's bit for bit.
"""

from __future__ import annotations

import ctypes
import dataclasses
from pathlib import Path
from typing import Callable, Optional

import numpy as np
import torch

from . import stages
from .rng import RngState
from .stages import C_COUNT, DRAIN_CAP, GATED_BATCH, N_CTRL, lane_field
from .stages import f32 as _f32

_SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "replaybody.cu"

# Float parameters (csrc/replaybody.cu FP_*).
FP_BMIN = 0
FP_BMAX = FP_BMIN + 3
FP_EXT = FP_BMAX + 3
FP_RM1 = FP_EXT + 3
FP_BSIZE = FP_RM1 + 3
FP_SCALE = FP_BSIZE + 3
FP_G = FP_SCALE + 1
FP_LE = FP_G + 1
FP_EPSW = FP_LE + 3
FP_ROUGH = FP_EPSW + 1
FP_ETA = FP_ROUGH + 2
FP_INV_ETA = FP_ETA + 1
N_FP = FP_INV_ETA + 1

# Integer parameters (csrc/replaybody.cu IP_*).
(IP_NX, IP_NY, IP_NZ, IP_NBX, IP_NBY, IP_HIX, IP_HIY, IP_HIZ, IP_BSDF,
 IP_MITSUBA, IP_RR, IP_MAXPATH, IP_RECORD, IP_CONST_ALB, IP_NCHAN,
 IP_THRESH, IP_CHAIN, IP_DRAIN_CAP, N_IP) = range(19)

# Record modes (IP_RECORD).
REC_NONE, REC_ATOMIC, REC_BUFFERS = range(3)

# Pointer slots (csrc/replaybody.cu S_*): the per-lane fields the body
# updates, in _Lanes' names, then the read-only per-lane ones, then the rest.
LANE_FIELDS = ("o", "d", "tput", "rad", "normal", "t", "brick_exit",
               "inv_sig", "rho_loc", "max_t", "bounce", "rng_state", "alive",
               "seg", "in_med")
N_LANE = len(LANE_FIELDS)
READ_FIELDS = ("rng_inc", "s_lane", "g_lane")
_DTYPES = dict(zip(LANE_FIELDS, (torch.float32,) * 10 + (torch.int64,) * 2
                   + (torch.bool,) * 3),
               rng_inc=torch.int64, s_lane=torch.float32, g_lane=torch.float32)
_VEC3 = ("o", "d", "tput", "rad", "normal", "g_lane")
S_RINC = N_LANE
S_SLANE, S_GLANE = S_RINC + 1, S_RINC + 2
S_OUT = S_GLANE + 1
S_COUNT = S_OUT + N_LANE
(S_SCRATCH, S_MAJOR, S_LEAP, S_DENSITY, S_ALBEDO, S_DD, S_DA, S_REC_DIDX,
 S_REC_DVAL, S_REC_AIDX, S_REC_AADJ, S_CTRL,
 S_ALB_EVALS) = range(S_COUNT + 1, S_COUNT + 14)
N_S = S_ALB_EVALS + 1

def route(device_type: str, eager_body: bool = False) -> bool:
    """Whether a replay's stages go to the kernel: on the card, unless the
    caller asks for the eager body (tests and chip_smoke.py hold the kernel
    against it).  The CPU has no kernel."""
    return device_type == "cuda" and not eager_body


def record_mode(record: bool) -> int:
    """REC_NONE for the primal, else REC_BUFFERS under
    torch.use_deterministic_algorithms and REC_ATOMIC otherwise."""
    if not record:
        return REC_NONE
    if torch.are_deterministic_algorithms_enabled():
        return REC_BUFFERS
    return REC_ATOMIC


@dataclasses.dataclass
class ReplayContext:
    """A replay's kernel inputs besides the pool: the parameter vectors
    (host numpy), the read-only tables, the cotangent accumulators (None
    for the primal) and the eager body (the plain version; it takes an
    optional `taps` list, see replay_bytes)."""

    fparams: np.ndarray  # (N_FP,) float32
    iparams: np.ndarray  # (N_IP,) int64
    major: torch.Tensor  # (n_bricks,) dilated majorants
    leap: torch.Tensor  # (n_bricks,) leap distances
    density: torch.Tensor  # (n_vox,)
    albedo: torch.Tensor  # (n_rows, n_chan)
    d_density: Optional[torch.Tensor]  # (n_vox,), pass B
    d_albedo: Optional[torch.Tensor]  # (n_rows, n_chan), pass B
    plain: Callable

    @property
    def record(self) -> int:
        return int(self.iparams[IP_RECORD])


def make_context(scene, settings, geo, record: bool, d_density, d_albedo,
                 plain: Callable) -> ReplayContext:
    """The kernel's parameters from the replay's scene, settings and
    `_Geometry` (the same tensors the eager body reads, read back to the
    host once per replay)."""
    med = scene.medium
    f = np.zeros(N_FP, np.float32)
    i = np.zeros(N_IP, np.int64)
    f[FP_BMIN:FP_BMIN + 3] = _f32(med.box_min)
    f[FP_BMAX:FP_BMAX + 3] = _f32(med.box_max)
    f[FP_EXT:FP_EXT + 3] = _f32(geo.extent)
    f[FP_RM1:FP_RM1 + 3] = _f32(geo.res_minus_1)
    f[FP_BSIZE:FP_BSIZE + 3] = _f32(geo.brick_size)
    f[FP_SCALE] = _f32(med.scale)[0]
    f[FP_G] = _f32(med.g)[0]
    f[FP_LE:FP_LE + 3] = _f32(scene.le)
    f[FP_EPSW] = _f32(geo.epsw)[0]
    f[FP_ROUGH:FP_ROUGH + 2] = _f32(scene.bsdf.roughness)
    f[FP_ETA] = _f32(scene.bsdf.eta)[0]
    f[FP_INV_ETA] = np.float32(1.0) / f[FP_ETA]
    i[IP_NX], i[IP_NY], i[IP_NZ] = geo.nx, geo.ny, geo.nz
    i[IP_NBX], i[IP_NBY] = geo.nbx, geo.nby
    i[IP_HIX:IP_HIZ + 1] = geo.brick_hi.cpu().numpy()
    i[IP_BSDF] = int(settings.bsdf_kind == "ggx")
    i[IP_MITSUBA] = int(settings.mitsuba_comparable)
    i[IP_RR] = int(settings.russian_roulette)
    i[IP_MAXPATH] = settings.max_path_length
    i[IP_RECORD] = record_mode(record)
    i[IP_CONST_ALB] = int(geo.const_alb)
    i[IP_NCHAN] = geo.albedo_flat.shape[-1]
    if i[IP_NCHAN] == 2:
        raise ValueError("replaybody: an albedo grid has 1, 3 or 4 channels")
    return ReplayContext(
        fparams=f, iparams=i, major=geo.major_flat, leap=geo.leap_flat,
        density=geo.density_flat, albedo=geo.albedo_flat,
        d_density=d_density if record else None,
        d_albedo=d_albedo if record else None, plain=plain,
    )


class ReplayBodyKernel(stages.BodyKernel):
    """The CUDA replay kernels, built from csrc/replaybody.cu at first use
    and counted (stages.BodyKernel); `plain_evals` counts the evaluations of
    the plain version (the eager body)."""

    def __init__(self):
        super().__init__("replaybody", _SOURCE, (N_FP, N_IP, N_S, N_CTRL))
        self.plain_evals = 0

    def _pointers(self, ctx: ReplayContext, s, out, count, ctrl=None,
                  rec=None, alb_evals=None):
        """The checked pointer array of launches on the pool `s` that write
        `out`'s per-lane tensors and the alive count to `count` (a 0-d int64
        tensor); `rec`, in buffer mode, the four record buffers;
        `alb_evals`, the drain's per-evaluation sums."""
        width = s.alive.shape[0]
        dev = s.alive.device
        fields = [lane_field(s, name) for name in LANE_FIELDS]
        outs = [lane_field(out, name) for name in LANE_FIELDS]
        for name, x, y in zip(LANE_FIELDS, fields, outs):
            _check(name, x, width, dev)
            if y is not x:
                _check(name, y, width, dev)
                if stages.overlaps(x, y):
                    raise ValueError(
                        f"replaybody: out.{name} overlaps the input partly")
        reads = [lane_field(s, name) for name in READ_FIELDS]
        for name, x in zip(READ_FIELDS, reads):
            _check(name, x, width, dev)
        nch = int(ctx.iparams[IP_NCHAN])
        tables = dict(major=ctx.major, leap=ctx.leap, density=ctx.density,
                      albedo=ctx.albedo, d_density=ctx.d_density,
                      d_albedo=ctx.d_albedo)
        for name, x in tables.items():
            if x is None:
                continue
            if (x.device != dev or x.dtype != torch.float32
                    or not x.is_contiguous()):
                raise ValueError(f"replaybody: {name} must be contiguous "
                                 f"float32 on {dev}")
        if ctx.record != REC_NONE:
            if ctx.d_density.numel() != ctx.density.numel() or tuple(
                    ctx.d_albedo.shape) != tuple(ctx.albedo.shape):
                raise ValueError("replaybody: the cotangents must have the "
                                 "shapes of the density and albedo tables")
        if ctx.albedo.ndim != 2 or ctx.albedo.shape[1] != nch:
            raise ValueError("replaybody: albedo must be (rows, n_chan)")
        ptrs = [0] * N_S
        for k, x in enumerate(fields):
            ptrs[k] = x.data_ptr()
        for k, x in enumerate(reads):
            ptrs[S_RINC + k] = x.data_ptr()
        for k, x in enumerate(outs):
            ptrs[S_OUT + k] = x.data_ptr()
        ptrs[S_COUNT] = count.data_ptr()
        # two counters and a constant albedo's three float64 sums of one
        # evaluation
        ptrs[S_SCRATCH] = self.zeros("scratch", 5, torch.int64, dev).data_ptr()
        for slot, x in ((S_MAJOR, ctx.major), (S_LEAP, ctx.leap),
                        (S_DENSITY, ctx.density), (S_ALBEDO, ctx.albedo),
                        (S_DD, ctx.d_density), (S_DA, ctx.d_albedo),
                        (S_CTRL, ctrl), (S_ALB_EVALS, alb_evals)):
            ptrs[slot] = 0 if x is None else x.data_ptr()
        if rec is not None:
            for slot, x in zip((S_REC_DIDX, S_REC_DVAL, S_REC_AIDX,
                                S_REC_AADJ), rec):
                ptrs[slot] = x.data_ptr()
        return (ctypes.c_void_p * N_S)(*ptrs)

    def launch(self, ctx: ReplayContext, s, out=None):
        """One replay evaluation of every lane of the pool `s` (a _Lanes):
        the new pool (its per-lane tensors `out`'s, or `s`'s, updated in
        place) and its alive count as a 0-d int64 tensor.  In buffer mode
        the lanes' adjoints are then added with index_add_, the eager
        body's calls."""
        dev = s.alive.device
        out = s if out is None else out
        width = s.alive.shape[0]
        count = torch.empty((), dtype=torch.int64, device=dev)
        rec = None
        if ctx.record == REC_BUFFERS:
            nch = int(ctx.iparams[IP_NCHAN])
            rec = (torch.empty(width, dtype=torch.int64, device=dev),
                   torch.empty(width, dtype=torch.float32, device=dev),
                   torch.empty(width, dtype=torch.int64, device=dev),
                   torch.empty((width, nch), dtype=torch.float32, device=dev))
        addresses = self._pointers(ctx, s, out, count, rec=rec)
        self.launch_one(self.args(ctx.fparams, ctx.iparams, addresses,
                                  width), dev)
        if rec is not None:
            _add_records(ctx, *rec)
        new = out._replace(rng=RngState(out.rng.state, s.rng.inc),
                           lane_id=s.lane_id, s_lane=s.s_lane, g_lane=s.g_lane)
        return new, count

    def gated(self, ctx: ReplayContext, s, thresh: int, k_chain: int,
              batch: int = GATED_BATCH):
        """A stage whose loop exits at a chain boundary once the alive count
        is at most `thresh` (> 0), in gated chains
        (stages.BodyKernel.gated): the pool, updated in place, and its
        evaluations."""
        if ctx.record == REC_BUFFERS:
            raise ValueError("replaybody: buffer mode runs per evaluation")
        dev = s.alive.device
        ctrl = torch.zeros(N_CTRL, dtype=torch.int64, device=dev)
        ctrl[C_COUNT] = torch.count_nonzero(s.alive)
        iparams = ctx.iparams.copy()
        iparams[IP_THRESH], iparams[IP_CHAIN] = thresh, k_chain
        addresses = self._pointers(ctx, s, s, ctrl[C_COUNT], ctrl)
        return s, super().gated(
            self.args(ctx.fparams, iparams, addresses, s.alive.shape[0]),
            ctrl, thresh, k_chain, dev, batch)

    def drain(self, ctx: ReplayContext, s, k_chain: int, cap: int = DRAIN_CAP):
        """The last stage (its loop exits at an alive count of 0), drained
        (stages.BodyKernel.drain): the pool, updated in place, and the
        loop's evaluations E = k_chain * ceil(L / k_chain)."""
        if ctx.record == REC_BUFFERS:
            raise ValueError("replaybody: buffer mode runs per evaluation")
        dev = s.alive.device
        ctrl = torch.zeros(N_CTRL, dtype=torch.int64, device=dev)
        ctrl[C_COUNT] = torch.count_nonzero(s.alive)
        iparams = ctx.iparams.copy()
        iparams[IP_CHAIN], iparams[IP_DRAIN_CAP] = k_chain, cap
        count = torch.empty((), dtype=torch.int64, device=dev)  # unused
        sums = self.zeros("alb_evals", 3 * cap, torch.float64, dev)
        addresses = self._pointers(ctx, s, s, count, ctrl, alb_evals=sums)
        words = super().drain(
            self.args(ctx.fparams, iparams, addresses, s.alive.shape[0]), (),
            ctrl, dev)
        return s, words[stages.C_TOTAL]


def _check(name, x, width, dev):
    shape = (width, 3) if name in _VEC3 else (width,)
    stages.check_lane("replaybody", name, x, _DTYPES[name], shape, dev)


def _add_records(ctx: ReplayContext, d_idx, d_val, a_idx, a_adj) -> None:
    """Buffer mode: one evaluation's adjoints into the cotangents, as the
    eager body adds them (_record_density, _record_albedo)."""
    ctx.d_density.index_add_(0, d_idx, d_val)
    if int(ctx.iparams[IP_CONST_ALB]):
        ctx.d_albedo += torch.sum(a_adj, dim=0, keepdim=True)
    else:
        ctx.d_albedo.index_add_(0, a_idx, a_adj)


KERNEL = ReplayBodyKernel()


def plain_body(ctx: ReplayContext, s):
    """One evaluation by the plain version (the eager body), on any device;
    counted in KERNEL.plain_evals.  Returns (the new pool, None)."""
    KERNEL.plain_evals += 1
    return ctx.plain(s), None


def run_body(ctx: ReplayContext, s, out=None):
    """One replay evaluation of the pool `s`: the plain version for CPU
    tensors, the CUDA kernel for CUDA tensors.  Returns the new pool and
    its alive count as a 0-d tensor, or None when the plain version ran
    (the caller counts)."""
    dev = s.alive.device
    if dev.type == "cpu":
        return plain_body(ctx, s)
    if dev.type == "cuda":
        return KERNEL.launch(ctx, s, out)
    raise ValueError(f"replaybody: no kernel for device {dev}")


def loop_stage(ctx: ReplayContext, s, thresh: int, k_chain: int,
               body: Callable = run_body):
    """The plain version of a stage (stages.loop_chains): chains of k_chain
    `body` evaluations while the pool's alive count exceeds `thresh`, the
    count read at each chain's end (the kernel's, or counted here; each
    read counts in KERNEL.reads).  Returns the pool and its evaluations."""
    return stages.loop_chains(
        KERNEL, s, lambda x: int(torch.count_nonzero(x.alive)),
        lambda x: body(ctx, x), thresh, k_chain)


def run_stage(ctx: ReplayContext, s, thresh: int, k_chain: int, last: bool):
    """One cascade stage of the fused replay: the pool once the loop of body
    evaluations would exit (the alive count at most `thresh` at a chain
    boundary), and its evaluations.  On the CPU `loop_stage`; on the card
    the drain for a threshold of 0 (only the last stage has it) and gated
    chains above it, both equal to `loop_stage` bit for bit, except in
    buffer mode (deterministic algorithms), which runs `loop_stage` with the
    kernel.  The kernels update the pool's per-lane tensors in place."""
    if s.alive.device.type != "cuda" or ctx.record == REC_BUFFERS:
        return loop_stage(ctx, s, thresh, k_chain)
    if thresh == 0:
        if not last:
            raise ValueError("replaybody: only the last stage drains")
        return KERNEL.drain(ctx, s, k_chain)
    return KERNEL.gated(ctx, s, thresh, k_chain)


#: bytes of each per-lane field of the pool (_Lanes; the RNG's two words
#: split), and of pass B's per-lane weights
FIELD_BYTES = dict(o=12, d=12, tput=12, rad=12, normal=12, t=4, brick_exit=4,
                   inv_sig=4, rho_loc=4, max_t=4, bounce=8, rng_state=8,
                   rng_inc=8, alive=1, seg=1, in_med=1, s_lane=4, g_lane=12)


def lane_traffic(before, after, reads: dict) -> dict:
    """One evaluation's per-lane state traffic, for replay_bytes
    (stages.lane_traffic over the pool's fields)."""
    return stages.lane_traffic(before, after, reads, FIELD_BYTES)


def replay_bytes(ctx: ReplayContext, taps) -> int:
    """The least bytes the evaluations whose `taps` are given move (the
    lists the eager body fills: ("state", lane_traffic), and ("tap", flat
    density indices), ("brick", brick rows), ("albedo", albedo rows) of the
    lanes that read them).  Each lane reads the fields its evaluation reads
    (a dead lane its alive flag alone) and writes the fields it changes;
    the distinct table entries are read once, and in pass B each touched
    cotangent entry is read and written once.  Given the taps of every
    evaluation of a drained stage, in order, the drain's: a lane's field is
    read once, unless an earlier evaluation wrote it, and written once."""
    nch = int(ctx.iparams[IP_NCHAN])
    record = ctx.record != REC_NONE
    n = stages.state_bytes(taps, FIELD_BYTES)

    def distinct(kind):
        xs = [x for k, x in taps if k == kind]
        return int(torch.unique(torch.cat(xs)).numel()) if xs else 0

    n_taps, n_rows = distinct("tap"), distinct("albedo")
    n += n_taps * 4 + distinct("brick") * 8 + n_rows * nch * 4
    if record:
        n += n_taps * 8 + n_rows * nch * 8
    return n
