"""render_diff's bounce-lockstep replays, one- and two-level, as CUDA
kernels (csrc/nestedreplay.cu).

JAX's `_replay` (cudavolumerenderer_tpu/models/differentiable.py:943) runs
`_replay_bounce` (:204, the one-level replay under the global majorant, the
default differentiable path) or `_replay_bounce_2l` (:344, the nested
two-level replay) under a `lax.while_loop` over bounces (:980), each with
its own tracking `lax.while_loop` (:270, :513); XLA compiled the whole into
one device program.  The port's eager loop (models/differentiable.py
`_nested_loop`) runs a few dozen torch launches per Woodcock step (eight
`index_add_` per step in pass B) and reads the device once per chain of
WOODCOCK_CHECK_EVERY steps and once per bounce.  The kernels run the whole
replay of every lane on the card, bit for bit the eager loop's:

  drain     one launch per replay (pass A; pass B with atomics): each lane
            runs its bounces to its end in registers;
  lockstep  pass B under torch.use_deterministic_algorithms: per bounce a
            start launch, one launch per chain of WOODCOCK_CHECK_EVERY
            steps writing the eager loop's (index, value) arrays, and an end
            launch, each read once as the eager loop reads its condition;
            the wrapper adds the arrays with index_add_ (and torch.sum for a
            constant two-level albedo) in the eager loop's order, so the
            cotangents are the eager loop's bit for bit.

This module holds the gate (`route`), the parameter vectors
(`make_context`), the wrapper `run` (the plain version, the eager loop, for
CPU tensors; the kernels for CUDA tensors, or it raises), the counts
(`KERNEL`) and the bound (`nested_bytes`).
"""

from __future__ import annotations

import ctypes
import dataclasses
from pathlib import Path
from typing import Callable, Optional

import numpy as np
import torch

from . import stages
from .replaybody import REC_ATOMIC, REC_BUFFERS, REC_NONE, record_mode  # noqa: F401
from .stages import f32 as _f32

_SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "nestedreplay.cu"

# Float parameters (csrc/nestedreplay.cu FP_*).
FP_BMIN = 0
FP_BMAX = FP_BMIN + 3
FP_EXT = FP_BMAX + 3
FP_RMD = FP_EXT + 3
FP_RMA = FP_RMD + 3
FP_BSIZE = FP_RMA + 3
FP_SCALE = FP_BSIZE + 3
FP_INV_SIGMAT = FP_SCALE + 1
FP_RHO_MAX = FP_INV_SIGMAT + 1
FP_G = FP_RHO_MAX + 1
FP_LE = FP_G + 1
FP_EPSW = FP_LE + 3
FP_ROUGH = FP_EPSW + 1
FP_ETA = FP_ROUGH + 2
FP_INV_ETA = FP_ETA + 1
N_FP = FP_INV_ETA + 1

# Integer parameters (csrc/nestedreplay.cu IP_*).
(IP_NX, IP_NY, IP_NZ, IP_NBX, IP_NBY, IP_HIX, IP_HIY, IP_HIZ, IP_AX, IP_AY,
 IP_AZ, IP_NCH, IP_NEAREST, IP_BSDF, IP_MITSUBA, IP_RR, IP_MAXPATH,
 IP_TWO_LEVEL, IP_RECORD, IP_CONST_ALB, IP_OP, IP_STEPS, N_IP) = range(23)

# The lockstep launch's entry points (IP_OP).
OP_START, OP_CHAIN, OP_END = range(3)

# Pointer slots (csrc/nestedreplay.cu S_*).
(S_O0, S_D0, S_RS0, S_RINC, S_SLANE, S_GLANE,
 S_O, S_D, S_TP, S_RAD, S_ALIVE, S_RS,
 S_MAXT, S_NRM, S_T, S_RUN, S_INMED, S_SCAT, S_TAPS, S_BEXIT, S_ISL, S_RLOC,
 S_DENSITY, S_ALBEDO, S_MAJOR, S_LEAP, S_DD, S_DA,
 S_REC_DIDX, S_REC_DVAL, S_REC_AIDX, S_REC_AVAL,
 S_SCRATCH, S_COUNT, S_STATS, N_S) = range(36)

#: Woodcock steps per host read of the running mask: the eager loop's
#: chains (models/differentiable.py) and the lockstep's (IP_STEPS)
WOODCOCK_CHECK_EVERY = 4

N_SCRATCH = 5  # csrc/nestedreplay.cu SC_*: two uint64 words, three doubles
N_STATS = 4  # csrc/nestedreplay.cu ST_*
N_TAPS = 8  # the one-level adjoints' taps (_trilerp_taps)

#: the lockstep's per-bounce lane fields: (slot, dtype, trailing shape)
_SEG_FIELDS = ((S_MAXT, torch.float32, ()), (S_NRM, torch.float32, (3,)),
               (S_T, torch.float32, ()), (S_RUN, torch.bool, ()),
               (S_INMED, torch.bool, ()), (S_SCAT, torch.bool, ()),
               (S_TAPS, torch.int64, ()), (S_BEXIT, torch.float32, ()),
               (S_ISL, torch.float32, ()), (S_RLOC, torch.float32, ()))


def route(device_type: str, eager_body: bool = False) -> bool:
    """Whether a nested replay goes to the kernels: on the card, unless the
    caller asks for the eager loop (tests and chip_smoke.py hold the kernels
    against it).  The CPU has no kernel."""
    return device_type == "cuda" and not eager_body


@dataclasses.dataclass
class NestedContext:
    """A replay's kernel inputs besides its lanes: the parameter vectors (host
    numpy), the read-only tables, the cotangent accumulators (None for a
    primal pass) and the eager loop (the plain version: plain(o0, d0, rng0,
    s_lane, g_lane, taps=None) -> (o, d, throughput, radiance, alive, rng),
    adding into d_density and d_albedo in pass B)."""

    fparams: np.ndarray  # (N_FP,) float32
    iparams: np.ndarray  # (N_IP,) int64
    density: torch.Tensor  # (n_vox,)
    albedo: torch.Tensor  # (n_rows, n_chan)
    major: Optional[torch.Tensor]  # (n_bricks,) two-level dilated majorants
    leap: Optional[torch.Tensor]  # (n_bricks,) their leap distances
    d_density: Optional[torch.Tensor]  # (n_vox,), pass B
    d_albedo: Optional[torch.Tensor]  # (n_rows, n_chan), pass B
    plain: Callable

    @property
    def record(self) -> int:
        return int(self.iparams[IP_RECORD])

    @property
    def two_level(self) -> bool:
        return bool(self.iparams[IP_TWO_LEVEL])


def make_context(scene, settings, geo, record: bool, d_density, d_albedo,
                 plain: Callable) -> NestedContext:
    """The kernels' parameters from the replay's scene and settings, and for
    the two-level replay its `_Geometry` (`geo`; None for one-level), read
    back to the host once per replay from the tensors the eager loop reads."""
    from . import woodcock  # noqa: PLC0415

    if settings.interpolation not in ("trilinear", "nearest"):
        raise ValueError(f"unknown interpolation {settings.interpolation!r}")
    med = scene.medium
    dens, alb = med.density.data, med.albedo.data
    if dens.ndim != 3 or alb.ndim != 4 or alb.shape[3] not in (1, 3, 4):
        raise ValueError("nestedreplay: the density is (Z, Y, X) and the "
                         "albedo (Z, Y, X, C) with 1, 3 or 4 channels")
    f = np.zeros(N_FP, np.float32)
    i = np.zeros(N_IP, np.int64)
    nz, ny, nx = dens.shape
    az, ay, ax, nch = alb.shape
    inv_sigmat, _ = woodcock._inv_sigmat(med.scale, med.max_density,
                                         dens.device)
    f[FP_BMIN:FP_BMIN + 3] = _f32(med.box_min)
    f[FP_BMAX:FP_BMAX + 3] = _f32(med.box_max)
    f[FP_EXT:FP_EXT + 3] = _f32(med.box_max - med.box_min)
    f[FP_RMD:FP_RMD + 3] = (nx - 1, ny - 1, nz - 1)
    f[FP_RMA:FP_RMA + 3] = (ax - 1, ay - 1, az - 1)
    f[FP_SCALE] = _f32(med.scale)[0]
    f[FP_INV_SIGMAT] = _f32(inv_sigmat)[0]
    f[FP_RHO_MAX] = _f32(med.max_density)[0]
    f[FP_G] = _f32(med.g)[0]
    f[FP_LE:FP_LE + 3] = _f32(scene.le)
    f[FP_ROUGH:FP_ROUGH + 2] = _f32(scene.bsdf.roughness)
    f[FP_ETA] = _f32(scene.bsdf.eta)[0]
    f[FP_INV_ETA] = np.float32(1.0) / f[FP_ETA]
    i[IP_NX], i[IP_NY], i[IP_NZ] = nx, ny, nz
    i[IP_AX], i[IP_AY], i[IP_AZ], i[IP_NCH] = ax, ay, az, nch
    i[IP_NEAREST] = int(settings.interpolation == "nearest")
    i[IP_BSDF] = int(settings.bsdf_kind == "ggx")
    i[IP_MITSUBA] = int(settings.mitsuba_comparable)
    i[IP_RR] = int(settings.russian_roulette)
    i[IP_MAXPATH] = settings.max_path_length
    i[IP_RECORD] = record_mode(record)
    i[IP_CONST_ALB] = int(az == ay == ax == 1)
    i[IP_STEPS] = WOODCOCK_CHECK_EVERY
    major = leap = None
    if geo is not None:
        i[IP_TWO_LEVEL] = 1
        f[FP_BSIZE:FP_BSIZE + 3] = _f32(geo.brick_size)
        f[FP_EPSW] = _f32(geo.epsw)[0]
        if not np.array_equal(f[FP_EXT:FP_EXT + 3], _f32(geo.extent)):
            raise ValueError("nestedreplay: the geometry's extent is not the "
                             "scene's")
        i[IP_NBX], i[IP_NBY] = geo.nbx, geo.nby
        i[IP_HIX:IP_HIZ + 1] = geo.brick_hi.cpu().numpy()
        major, leap = geo.major_flat.contiguous(), geo.leap_flat.contiguous()
    return NestedContext(
        fparams=f, iparams=i, density=dens.contiguous().reshape(-1),
        albedo=alb.contiguous().reshape(-1, nch), major=major, leap=leap,
        d_density=d_density if record else None,
        d_albedo=d_albedo if record else None, plain=plain,
    )


class NestedReplayKernel(stages.BodyKernel):
    """The CUDA kernels of csrc/nestedreplay.cu, built at first use and
    counted: `drain_launches` (one per replay), `launches` (the lockstep
    launches of deterministic pass B), `reads` (the host's reads of the
    lockstep's count); the plain version's `plain_passes` (eager replays)
    and `plain_reads` (their reads of the running and alive masks).
    `last_drain` holds the last drain's stats tensor (read on demand by
    `drain_stats`)."""

    def __init__(self):
        super().__init__("nestedreplay", _SOURCE,
                         (N_FP, N_IP, N_S, stages.N_CTRL))
        self.plain_passes = 0
        self.plain_reads = 0

    def reset(self) -> None:
        self.launches = self.captured = self.drain_launches = self.reads = 0
        self.plain_passes = self.plain_reads = 0

    def _pointers(self, ctx: NestedContext, lanes: dict, dev):
        ptrs = [0] * N_S
        tables = {S_DENSITY: ctx.density, S_ALBEDO: ctx.albedo,
                  S_MAJOR: ctx.major, S_LEAP: ctx.leap, S_DD: ctx.d_density,
                  S_DA: ctx.d_albedo}
        for slot, x in list(tables.items()) + list(lanes.items()):
            if x is None:
                continue
            if x.device != dev or not x.is_contiguous():
                raise ValueError(f"nestedreplay: pointer slot {slot} must be "
                                 f"contiguous on {dev}")
            ptrs[slot] = x.data_ptr()
        ptrs[S_SCRATCH] = self.zeros("scratch", N_SCRATCH, torch.int64,
                                     dev).data_ptr()
        return (ctypes.c_void_p * N_S)(*ptrs)

    def drain(self, ctx: NestedContext, lanes: dict, width: int, dev):
        """One drain launch over `lanes` (slot -> tensor: the start, pass B's
        weights and the end buffers); the stats tensor."""
        if ctx.record == REC_BUFFERS:
            raise ValueError("nestedreplay: buffer mode runs the lockstep")
        stats = torch.zeros(N_STATS, dtype=torch.int64, device=dev)
        lanes = {**lanes, S_STATS: stats}
        addresses = self._pointers(ctx, lanes, dev)
        fn = self._entry(self.library(), "drain")
        with torch.cuda.device(dev):
            self._raise(fn(*self.args(ctx.fparams, ctx.iparams, addresses,
                                      width),
                           torch.cuda.current_stream(dev).cuda_stream),
                        "drain")
        self.drain_launches += 1
        self.last_drain = stats
        return stats

    def lockstep(self, ctx: NestedContext, lanes: dict, width: int,
                 dev) -> None:
        """Deterministic pass B over `lanes` (updated in place from the start
        copied into the end buffers): the eager loop's bounces, chains and
        reads, and its index_add_ calls on the kernels' records."""
        two = ctx.two_level
        nch = int(ctx.iparams[IP_NCH])
        taps = 1 if two else N_TAPS
        k_chain = int(ctx.iparams[IP_STEPS])
        count = torch.zeros((), dtype=torch.int64, device=dev)
        seg = {slot: torch.zeros((width,) + shape, dtype=dtype, device=dev)
               for slot, dtype, shape in _SEG_FIELDS}
        didx = torch.empty((k_chain, taps, width), dtype=torch.int64,
                           device=dev)
        dval = torch.empty((k_chain, taps, width), dtype=torch.float32,
                           device=dev)
        arows = 1 if two else N_TAPS
        aidx = torch.empty((arows, width), dtype=torch.int64, device=dev)
        aval = torch.empty((arows, width, nch), dtype=torch.float32,
                           device=dev)
        lanes = {**lanes, **seg, S_REC_DIDX: didx, S_REC_DVAL: dval,
                 S_REC_AIDX: aidx, S_REC_AVAL: aval, S_COUNT: count}
        addresses = self._pointers(ctx, lanes, dev)
        # each entry point's integer vector, kept alive while its address is
        # passed to the launches
        iparams = {op: ctx.iparams.copy() for op in (OP_START, OP_CHAIN,
                                                     OP_END)}
        params = {}
        for op, p in iparams.items():
            p[IP_OP] = op
            params[op] = self.args(ctx.fparams, p, addresses, width)
        const_alb = bool(ctx.iparams[IP_CONST_ALB])

        def read():
            self.reads += 1
            return int(count)

        bounce = 0
        while bounce < int(ctx.iparams[IP_MAXPATH]):
            if bounce > 0 and read() == 0:
                break
            self.launch_one(params[OP_START], dev)
            while read() > 0:
                self.launch_one(params[OP_CHAIN], dev)
                for k in range(k_chain):
                    for j in range(taps):
                        ctx.d_density.index_add_(0, didx[k, j], dval[k, j])
            self.launch_one(params[OP_END], dev)
            if two and const_alb:
                ctx.d_albedo += torch.sum(aval[0], dim=0, keepdim=True)
            elif const_alb:
                ctx.d_albedo += one_row_sum(aval.unbind(0))
            else:
                for j in range(arows):
                    ctx.d_albedo.index_add_(0, aidx[j], aval[j])
            bounce += 1


KERNEL = NestedReplayKernel()


def one_row_sum(adjoints) -> torch.Tensor:
    """The (1, C) float32 sum of (N, C) float32 adjoints headed for a
    constant albedo's one row, taken in double (the one-level replay's)."""
    total = sum(torch.sum(a, dim=0, keepdim=True, dtype=torch.float64)
                for a in adjoints)
    return total.to(torch.float32)


def drain_stats(stats: torch.Tensor) -> dict:
    """A drain's stats (one host read): the longest lane's Woodcock steps
    and bounces, the most bounces of any lane, and all lanes' steps and
    bounces."""
    longest, bounces, steps, bounces_all = (int(x) for x in stats.tolist())
    return {"longest_steps": longest >> 24,
            "longest_bounces": longest & ((1 << 24) - 1),
            "max_bounces": bounces, "steps": steps, "bounces": bounces_all}


def run(ctx: NestedContext, o0, d0, rng0, s_lane, g_lane):
    """The whole replay of the lanes starting at (o0, d0, rng0): (o, d,
    throughput, radiance, alive, rng state) at their end, adding pass B's
    adjoints into the context's cotangents.  The plain version (the eager
    loop) for CPU tensors; on CUDA tensors the drain, or in buffer mode the
    lockstep launches (WOODCOCK_CHECK_EVERY steps per chain, as the eager
    loop); a failed build or launch raises."""
    dev = o0.device
    if dev.type == "cpu":
        return ctx.plain(o0, d0, rng0, s_lane, g_lane)
    if dev.type != "cuda":
        raise ValueError(f"nestedreplay: no kernel for device {dev}")
    width = o0.shape[0]

    def lane(x, dtype, shape):
        stages.check_lane("nestedreplay", "a lane field", x, dtype,
                          (width,) + shape, dev)
        return x

    start = {S_O0: lane(o0.contiguous(), torch.float32, (3,)),
             S_D0: lane(d0.contiguous(), torch.float32, (3,)),
             S_RS0: lane(rng0.state.contiguous(), torch.int64, ()),
             S_RINC: lane(rng0.inc.contiguous(), torch.int64, ())}
    if ctx.record != REC_NONE:
        start[S_SLANE] = lane(s_lane.contiguous(), torch.float32, ())
        start[S_GLANE] = lane(g_lane.contiguous(), torch.float32, (3,))
    out = {S_O: torch.empty((width, 3), dtype=torch.float32, device=dev),
           S_D: torch.empty((width, 3), dtype=torch.float32, device=dev),
           S_TP: torch.empty((width, 3), dtype=torch.float32, device=dev),
           S_RAD: torch.empty((width, 3), dtype=torch.float32, device=dev),
           S_ALIVE: torch.empty(width, dtype=torch.bool, device=dev),
           S_RS: torch.empty(width, dtype=torch.int64, device=dev)}
    if ctx.record == REC_BUFFERS:
        # the lockstep runs on the end buffers, from the replay's start
        out[S_O].copy_(start[S_O0])
        out[S_D].copy_(start[S_D0])
        out[S_TP].fill_(1.0)
        out[S_RAD].zero_()
        out[S_ALIVE].fill_(True)
        out[S_RS].copy_(start[S_RS0])
        KERNEL.lockstep(ctx, {**start, **out}, width, dev)
    else:
        KERNEL.drain(ctx, {**start, **out}, width, dev)
    return (out[S_O], out[S_D], out[S_TP], out[S_RAD], out[S_ALIVE],
            out[S_RS])


class DistinctTaps(list):
    """A `taps` list for a long replay: each kind's entries are kept
    distinct as they arrive (nested_bytes counts distinct entries), so the
    list holds one tensor per kind."""

    def append(self, item):
        kind, x = item
        x = x.reshape(-1)
        for i, (k, y) in enumerate(self):
            if k == kind:
                self[i] = (k, torch.unique(torch.cat([y, x])))
                return
        super().append((kind, torch.unique(x)))

    def __iadd__(self, items):
        for item in items:
            self.append(item)
        return self


#: bytes per lane of each field a replay reads at its start or writes at
#: its end (the RNG's two words split)
FIELD_BYTES = dict(o=12, d=12, tput=12, rad=12, alive=1, rng_state=8,
                   rng_inc=8, s_lane=4, g_lane=12)


def nested_bytes(ctx: NestedContext, taps, o0, d0, rng0, out) -> int:
    """The least bytes a replay moves, from the eager loop's `taps` list
    (("density", voxels read), ("brick", brick rows read), ("albedo", albedo
    rows read), ("d_density", "d_albedo": cotangent entries added to) and
    the replay's start (o0, d0, rng0) and end `out` ((o, d, throughput,
    radiance, alive, rng state)).  Per lane: o and d are read; a lane that
    drew reads its RNG's two words (and s and g in pass B); each end field
    that differs from the start (throughput 1, radiance 0, alive) is
    written.  Each distinct table entry is read once (a brick row's majorant
    and leap, 8 B; an albedo row, 4 B per channel), and in pass B each
    cotangent entry added to is read and written once."""
    o, d, tput, rad, alive, rs = out
    record = ctx.record != REC_NONE
    nch = int(ctx.iparams[IP_NCH])
    drew = stages.changed(rng0.state, rs)
    moved = {
        "o": stages.changed(o0, o), "d": stages.changed(d0, d),
        "tput": stages.changed(torch.ones_like(tput), tput),
        "rad": stages.changed(torch.zeros_like(rad), rad), "alive": ~alive,
        "rng_state": drew,
    }
    n = o0.shape[0] * (FIELD_BYTES["o"] + FIELD_BYTES["d"])
    per_draw = FIELD_BYTES["rng_state"] + FIELD_BYTES["rng_inc"]
    if record:
        per_draw += FIELD_BYTES["s_lane"] + FIELD_BYTES["g_lane"]
    n += per_draw * int(torch.count_nonzero(drew))
    n += sum(FIELD_BYTES[k] * int(torch.count_nonzero(m))
             for k, m in moved.items())

    def distinct(kind):
        xs = [x.reshape(-1) for k, x in taps if k == kind]
        return int(torch.unique(torch.cat(xs)).numel()) if xs else 0

    n += 4 * distinct("density") + 8 * distinct("brick")
    n += 4 * nch * distinct("albedo")
    if record:
        n += 8 * distinct("d_density") + 8 * nch * distinct("d_albedo")
    return n
