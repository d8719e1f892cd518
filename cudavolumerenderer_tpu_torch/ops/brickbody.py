"""brickSK's round as CUDA kernels (csrc/brickbody.cu).

On the TPU brickSK's rounds are one `lax.while_loop` that XLA compiled into
one device program (cudavolumerenderer_tpu/models/brick.py:464: `phase_a`
:185, `kernel_round` :365 around the Pallas tracking kernel, the argsort
:387 and the packed permutation :388).  The port's eager loop
(models/brick.py `eager_loop`) runs a round as ~1,150 torch launches and a
host read of the loop condition; here a round is a handful of launches and
no read:

  phase_a  one thread per lane: models/brick.phase_a and the lane's sort
           key (round_keys), the lane written in place, the key in
           position order;
  sort     the stable sort of the keys into skeys and order
           (ops/lanesort.brick_sort_, csrc/lanesort.cu: a keys launch and
           a radix pass per 8 bits of n_bricks), what torch.sort(keys,
           stable=True) gives, as JAX's argsort was an XLA op;
  round    one block per row of 128 sorted positions: models/brick's
           track_rows (K tracking steps in the row's brick, tracking.cu's
           loop), the lane found through the order.

The eager loop permutes the whole state after each sort.  The kernels keep
every lane where it is and carry `pos` (lane -> sorted position); phase A
rebuilds `perm` (position -> lane) from it, and the round writes each
lane's new position.  The keys are sorted in position order, so the stable
sort's ties, the rows, the rounds and every path equal the eager loop's.

On the card `run_rounds` enqueues rounds `stages.GATED_BATCH` at a time
and reads the loop's control words once per batch; every launch of a
round, the sort's too, returns untouched once the loop's count (lanes
alive or with samples left, left by phase A and moved into the words by
the round) is 0.  The eager loop (`run_rounds` without the kernels) keeps
torch.sort.

This module holds the gate (`route`), the parameter and pointer layout
(checked against the C layout at load), the plain versions in this
layout (`plain_phase_a`, `plain_round`: the eager functions of
models/brick.py on the state gathered into position order and scattered
back), the wrappers (`phase_a`, `round_`: the plain version for CPU
tensors, the kernel for CUDA tensors, or they raise), the runners
(`run_rounds`: the gated kernels, or the plain loop in this layout) and the
bound (`brick_bytes`).
"""

from __future__ import annotations

import ctypes
import dataclasses
from pathlib import Path

import numpy as np
import torch

from . import lanesort, stages
from .rng import as_u32, mul32
from .stages import C_COUNT, N_CTRL, lane_field, own
from .stages import f32 as _f32

_SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "brickbody.cu"

# Float parameters (csrc/brickbody.cu FP_*).
FP_BMIN = 0
FP_BMAX = FP_BMIN + 3
FP_EXT = FP_BMAX + 3
FP_RM1 = FP_EXT + 3
FP_BSIZE = FP_RM1 + 3
FP_VOXS = FP_BSIZE + 3
FP_SCALE = FP_VOXS + 3
FP_G = FP_SCALE + 1
FP_LE = FP_G + 1
FP_ALB_A = FP_LE + 3
FP_ALB_B = FP_ALB_A + 3
FP_ROUGH = FP_ALB_B + 3
FP_ETA = FP_ROUGH + 2
(FP_INV_ETA, FP_EPSW, FP_TILEX, FP_TILEY, FP_INV_TW, FP_INV_RESX,
 FP_INV_RESY) = range(FP_ETA + 1, FP_ETA + 8)
FP_CAM = FP_INV_RESY + 1  # the camera's (3, 4) inv_view, row-major
FP_R2VX = FP_CAM + 12
FP_R2VY = FP_R2VX + 1
N_FP = FP_R2VY + 1

# Integer parameters (csrc/brickbody.cu IP_*).
(IP_OP, IP_NX, IP_NY, IP_NZ, IP_NBX, IP_NBY, IP_NBZ, IP_NBRICKS, IP_TABLE,
 IP_ALBEDO, IP_BSDF, IP_MITSUBA, IP_RR, IP_SPP, IP_M, IP_NPIX, IP_TW,
 IP_BASE, IP_SEEDH, IP_KSTEPS, N_IP) = range(21)

#: the entry points (IP_OP)
OPS = ("phase_a", "round")

# Pointer slots (csrc/brickbody.cu S_*): the per-lane fields in BrickState's
# names (the RNG's two words split) and pos, their outputs, then the rest.
LANE_FIELDS = ("o", "d", "throughput", "accum", "normal", "base", "t",
               "max_t", "brick_exit", "inv_sig", "pix", "samples_done",
               "status", "alive", "tracking", "rng_state", "rng_inc", "pos")
N_LANE = len(LANE_FIELDS)
STATE_FIELDS = LANE_FIELDS[:-1]  # a BrickState's
_VEC3 = ("o", "d", "throughput", "accum", "normal", "base")
_DTYPES = {n: torch.float32 for n in _VEC3 + ("t", "max_t", "brick_exit",
                                              "inv_sig")}
_DTYPES.update({n: torch.int64 for n in ("pix", "samples_done", "status",
                                         "rng_state", "rng_inc", "pos")})
_DTYPES.update(alive=torch.bool, tracking=torch.bool)
S_OUT = N_LANE
(S_PERM, S_KEYS, S_SKEYS, S_ORDER, S_NRAYS, S_NRAYS_OUT, S_COUNT, S_FUSED,
 S_MAJOR, S_TABLES, S_SCRATCH, S_CTRL) = range(S_OUT + N_LANE,
                                                S_OUT + N_LANE + 12)
N_S = S_CTRL + 1
N_SCRATCH = 4  # csrc/brickbody.cu SC_*

#: the fields each entry point writes (pos: phase A only out of place)
WRITES = {
    "phase_a": tuple(n for n in LANE_FIELDS if n not in ("pix", "pos")),
    "round": ("t", "status", "rng_state", "pos"),
}

#: the kernel's sort key of a lane that cannot track (int32; it sorts after
#: every brick id, as the eager loop's 0xFFFFFFFF does)
SENTINEL = 0x7FFFFFFF
MASKED = 4  # models/brick.MASKED
# common.cuh's fused layouts and albedo modes
FUSED_F32, FUSED_ROWS = 0, 1
ALBEDO_MODES = {"const": 0, "affine": 1, "full": 2}


def route(device_type: str, eager_body: bool = False) -> bool:
    """Whether brickSK's rounds go to the kernels: on the card unless the
    caller asks for the eager loop (tests and chip_smoke.py hold the
    kernels against it); the CPU runs the eager loop."""
    return device_type == "cuda" and not eager_body


def perm_of(pos: torch.Tensor) -> torch.Tensor:
    """The lane at each sorted position (the inverse of pos)."""
    perm = torch.empty_like(pos)
    perm[pos] = torch.arange(pos.shape[0], dtype=pos.dtype, device=pos.device)
    return perm


def _take(s, idx: torch.Tensor):
    from ..models.fast import _take_lanes  # noqa: PLC0415

    return _take_lanes(s, idx)


def to_kernel_keys(keys: torch.Tensor) -> torch.Tensor:
    """The eager loop's int64 keys (sentinel 0xFFFFFFFF) as the kernel's
    int32 keys (sentinel SENTINEL): the same order."""
    from ..models.brick import _SENTINEL  # noqa: PLC0415

    return torch.where(keys == _SENTINEL, SENTINEL, keys).to(torch.int32)


# -- the plain versions --------------------------------------------------------

def plain_phase_a(ctx, s, pos, taps=None):
    """Phase A of a lane-ordered state `s` whose lanes sit at sorted
    positions `pos`, by the eager function on the state in position order:
    (s', keys (int32, position order), perm, the loop's count (0-d
    int64)).  A list given as `taps` receives ("state", lane traffic),
    ("keys", lanes) and the eager function's taps (brick_bytes)."""
    from ..models import brick  # noqa: PLC0415

    KERNEL.plain_evals["phase_a"] += 1
    perm = perm_of(pos)
    inner = [] if taps is not None else None
    sp = brick.phase_a(ctx, _take(s, perm), taps=inner)
    keys = to_kernel_keys(brick.round_keys(ctx, sp))
    new = _take(sp, pos)
    if taps is not None:
        taps += [x for x in inner if x[0] != "lanes"]
        lanes = next(x[1] for x in inner if x[0] == "lanes")
        lanes = {k: v[pos] for k, v in lanes.items()}
        taps.append(("state", _phase_a_traffic(ctx, s, new, lanes)))
        taps.append(("keys", torch.ones_like(s.alive)))
    return new, keys, perm, brick.pending_count(ctx, new)


def plain_round(ctx, s, pos, perm, skeys, order, taps=None):
    """The tracking round of a lane-ordered state after phase A (its lanes
    at positions `pos`, `perm` their inverse) on the sort's keys `skeys`
    and `order`: (s', pos') with each lane's new position.  A list given
    as `taps` receives ("state", lane traffic), ("order", lanes) and the
    steps' ("table", words)."""
    from ..models import brick  # noqa: PLC0415

    KERNEL.plain_evals["round"] += 1
    lanes = perm[order]  # the lane at each new position
    new_pos = perm_of(lanes)
    inner = [] if taps is not None else None
    ss = brick.track_rows(ctx, _take(s, lanes), skeys.to(torch.int64),
                          SENTINEL, taps=inner)
    new = _take(ss, new_pos)
    if taps is not None:
        taps += inner
        key_rows = skeys.reshape(-1, 128)
        usable = ((key_rows == key_rows[:, :1])
                  & (key_rows[:, :1] != SENTINEL)).reshape(-1)[new_pos]
        none = torch.zeros_like(usable)
        reads = {n: usable for n in ("o", "d", "base", "t", "max_t",
                                     "brick_exit", "inv_sig", "rng_state",
                                     "rng_inc")}
        reads.update({n: none for n in ("throughput", "accum", "normal",
                                        "pix", "samples_done", "status",
                                        "alive", "tracking")})
        taps.append(("state", stages.lane_traffic(s, new, reads,
                                                  STATE_FIELDS)))
        taps.append(("order", torch.ones_like(usable)))
    return new, new_pos


def _phase_a_traffic(ctx, before, after, lanes) -> dict:
    """Phase A's per-lane traffic: the fields a lane's branch reads (every
    lane its flags and sample count; a path in flight its ray, throughput,
    RNG and tracking fields; a tracking lane its status; a box exit its
    normal; a miss its accumulator; a new path its pixel) and the ones it
    changes."""
    every = torch.ones_like(before.alive)
    none = torch.zeros_like(every)
    flight, trk = before.alive, before.tracking
    reads = {"alive": every, "tracking": every, "samples_done": every,
             "status": trk, "pix": lanes["needs"], "normal":
             lanes["exited_box"], "accum": lanes["miss"], "base": none,
             "inv_sig": trk | after.tracking}
    reads.update({n: flight for n in ("o", "d", "throughput", "rng_state",
                                      "rng_inc")})
    reads.update({n: trk for n in ("t", "max_t", "brick_exit")})
    return stages.lane_traffic(before, after, reads, STATE_FIELDS)


# -- the kernels ---------------------------------------------------------------

@dataclasses.dataclass
class RoundBuffers:
    """A round's device scratch besides the lanes: perm and the keys in
    position order (phase A's), the sort's keys and order, the loop's
    count (phase A's, for the round)."""

    perm: torch.Tensor  # (N,) int64
    keys: torch.Tensor  # (N,) int32
    skeys: torch.Tensor  # (N,) int32
    order: torch.Tensor  # (N,) int64
    count: torch.Tensor  # () int64

    @classmethod
    def make(cls, n: int, dev) -> "RoundBuffers":
        def e(dtype, *shape):
            return torch.empty(shape, dtype=dtype, device=dev)

        return cls(e(torch.int64, n), e(torch.int32, n), e(torch.int32, n),
                   e(torch.int64, n), e(torch.int64))

    def sort(self, ctrl=None, n_bricks=None) -> None:
        """The stable sort of the keys into skeys and order
        (lanesort.brick_sort_: torch.sort on the CPU, the kernels on the
        card, gated on `ctrl` when given; n_bricks bounds the keys)."""
        lanesort.brick_sort_(self, ctrl, n_bricks)


@dataclasses.dataclass
class Prepared:
    """The arguments of one launch of an entry point, and the host arrays
    and tensors they point at (kept alive with them)."""

    op: str
    args: tuple
    keep: tuple


def _kernel_params(ctx):
    """(fparams, iparams) from the context's tensors, read back once.  A
    division by a Python scalar runs on the card as a multiplication by
    the scalar's float32 reciprocal, so those reciprocals are what the
    vector holds."""
    scene, settings, med = ctx.scene, ctx.settings, ctx.scene.medium
    if ctx.albedo_mode not in ALBEDO_MODES:
        raise ValueError(f"brickbody: no kernel for albedo mode "
                         f"{ctx.albedo_mode!r}")
    f = np.zeros(N_FP, np.float32)
    i = np.zeros(N_IP, np.int64)
    one = np.float32(1.0)
    f[FP_BMIN:FP_BMIN + 3] = _f32(med.box_min)
    f[FP_BMAX:FP_BMAX + 3] = _f32(med.box_max)
    f[FP_EXT:FP_EXT + 3] = _f32(ctx.extent)
    f[FP_RM1:FP_RM1 + 3] = _f32(ctx.res_minus_1)
    f[FP_BSIZE:FP_BSIZE + 3] = _f32(ctx.brick_size)
    f[FP_VOXS:FP_VOXS + 3] = _f32(ctx.res_minus_1 / ctx.extent)
    f[FP_SCALE] = _f32(med.scale)[0]
    f[FP_G] = _f32(med.g)[0]
    f[FP_LE:FP_LE + 3] = _f32(scene.le)
    if ctx.albedo_mode == "const":
        f[FP_ALB_B:FP_ALB_B + 3] = _f32(
            med.albedo.data.reshape(-1)[:3].expand(3))
    elif ctx.albedo_mode == "affine":
        f[FP_ALB_A:FP_ALB_A + 3] = _f32(med.albedo_affine[0])
        f[FP_ALB_B:FP_ALB_B + 3] = _f32(med.albedo_affine[1])
    f[FP_ROUGH:FP_ROUGH + 2] = _f32(scene.bsdf.roughness)
    f[FP_ETA] = _f32(scene.bsdf.eta)[0]
    f[FP_INV_ETA] = one / f[FP_ETA]
    f[FP_EPSW] = _f32(ctx.epsw)[0]
    f[FP_TILEX:FP_TILEY + 1] = _f32(ctx.tile_offset)
    tw = ctx.tile_dim[0]
    f[FP_INV_TW] = one / np.float32(tw)
    f[FP_INV_RESX] = one / np.float32(float(ctx.full_resolution[0]))
    f[FP_INV_RESY] = one / np.float32(float(ctx.full_resolution[1]))
    f[FP_CAM:FP_CAM + 12] = _f32(ctx.camera.inv_view)
    f[FP_R2VX:FP_R2VY + 1] = _f32(ctx.camera.raster_to_view)
    nz, ny, nx = med.density.data.shape
    nbz, nby, nbx = ctx.n_bricks_zyx
    i[IP_NX], i[IP_NY], i[IP_NZ] = nx, ny, nz
    i[IP_NBX], i[IP_NBY], i[IP_NBZ] = nbx, nby, nbz
    i[IP_NBRICKS] = ctx.n_bricks
    if ctx.n_bricks >= SENTINEL:
        raise ValueError("brickbody: too many bricks for int32 keys")
    i[IP_TABLE] = FUSED_ROWS if ctx.albedo_mode == "full" else FUSED_F32
    i[IP_ALBEDO] = ALBEDO_MODES[ctx.albedo_mode]
    i[IP_BSDF] = int(settings.bsdf_kind == "ggx")
    i[IP_MITSUBA] = int(settings.mitsuba_comparable)
    i[IP_RR] = int(settings.russian_roulette)
    i[IP_SPP], i[IP_M] = ctx.spp_per_lane, ctx.m
    i[IP_NPIX], i[IP_TW], i[IP_BASE] = ctx.n_pix, tw, ctx.base_id
    seed = ctx.seed if isinstance(ctx.seed, torch.Tensor) else int(ctx.seed)
    i[IP_SEEDH] = int(mul32(as_u32(seed, "cpu").cpu(), 0x9E3779B9))
    i[IP_KSTEPS] = ctx.k_steps
    return f, i


def params(ctx):
    """The context's kernel parameters (built once)."""
    if ctx._params is None:
        ctx._params = _kernel_params(ctx)
    return ctx._params


class BrickBodyKernel(stages.BodyKernel):
    """The CUDA brickSK kernels, built from csrc/brickbody.cu at first use
    and counted (stages.BodyKernel): `by_op` counts each entry point's
    launches made now (a gated one may return untouched), `plain_evals`
    each one's evaluations by its plain version, `sorts` the sorts the
    gated runner enqueued (their launches count in lanesort.KERNEL)."""

    def __init__(self):
        super().__init__("brickbody", _SOURCE, (N_FP, N_IP, N_S, N_CTRL),
                         has_drain=False)
        self.reset()

    def reset(self) -> None:
        """Every count to 0."""
        self.launches = self.captured = self.reads = 0
        self.enqueue_s = 0.0
        self.sorts = 0
        self.by_op = dict.fromkeys(OPS, 0)
        self.plain_evals = dict.fromkeys(OPS, 0)

    def prepare(self, ctx, op: str, s, pos, bufs: RoundBuffers, *, out=None,
                pos_out=None, n_rays_out=None, ctrl=None) -> Prepared:
        """The checked arguments of launches of `op` on the lane-ordered
        state `s` at positions `pos` with the round's buffers `bufs`,
        writing `out`'s and `pos_out`'s lanes (s's and pos when None) and
        n_rays to `n_rays_out` (s.n_rays in place when None); gated on
        `ctrl` when given."""
        fparams, iparams0 = params(ctx)
        out = s if out is None else out
        pos_out = pos if pos_out is None else pos_out
        dev = s.alive.device
        width = s.alive.shape[0]
        if op == "round" and width % 128:
            raise ValueError("brickbody: a round needs lanes in rows of 128")
        fields = {n: lane_field(s, n) for n in STATE_FIELDS}
        fields["pos"] = pos
        outs = {n: lane_field(out, n) for n in STATE_FIELDS}
        outs["pos"] = pos_out
        for name, x in fields.items():
            _check(name, x, width, dev)
            y = outs[name]
            if y is not x:
                _check(name, y, width, dev)
                if stages.overlaps(x, y):
                    raise ValueError(
                        f"brickbody: out.{name} overlaps the input partly")
        if (out is s) != (pos_out is pos) or (out is s) != all(
                outs[n] is fields[n] for n in fields):
            raise ValueError("brickbody: write every field in place or "
                             "every one out of place")
        for name, x, dtype in (
                ("perm", bufs.perm, torch.int64),
                ("keys", bufs.keys, torch.int32),
                ("skeys", bufs.skeys, torch.int32),
                ("order", bufs.order, torch.int64)):
            stages.check_lane("brickbody", name, x, dtype, (width,), dev)
        for name, x in (("n_rays", s.n_rays), ("n_rays_out", n_rays_out)):
            if x is not None and (x.device != dev or x.dtype != torch.float32
                                  or x.ndim != 0):
                raise ValueError(f"brickbody: {name} must be a 0-d float32 "
                                 f"tensor on {dev}")
        tables = (ctx.fused, ctx.bm_flat, ctx.tables)
        for name, x in zip(("fused", "majorants", "tables"), tables):
            if (x.device != dev or x.dtype != torch.float32
                    or not x.is_contiguous()):
                raise ValueError(f"brickbody: {name} must be contiguous "
                                 f"float32 on {dev}")
        if ctrl is not None:
            stages.check_lane("brickbody", "ctrl", ctrl, torch.int64,
                              (N_CTRL,), dev)
        iparams = iparams0.copy()
        iparams[IP_OP] = OPS.index(op)
        ptrs = [0] * N_S
        for name, x in fields.items():
            ptrs[LANE_FIELDS.index(name)] = x.data_ptr()
            ptrs[S_OUT + LANE_FIELDS.index(name)] = outs[name].data_ptr()
        for slot, x in (
                (S_PERM, bufs.perm), (S_KEYS, bufs.keys),
                (S_SKEYS, bufs.skeys), (S_ORDER, bufs.order),
                (S_NRAYS, s.n_rays),
                (S_NRAYS_OUT, s.n_rays if n_rays_out is None else n_rays_out),
                (S_COUNT, bufs.count), (S_FUSED, ctx.fused),
                (S_MAJOR, ctx.bm_flat), (S_TABLES, ctx.tables),
                (S_SCRATCH, self.zeros("scratch", N_SCRATCH, torch.int64,
                                       dev)),
                (S_CTRL, ctrl)):
            ptrs[slot] = 0 if x is None else x.data_ptr()
        addresses = (ctypes.c_void_p * N_S)(*ptrs)
        return Prepared(op, self.args(fparams, iparams, addresses, width),
                        (fparams, iparams, addresses, bufs, *tables, fields,
                         outs, s.n_rays, n_rays_out, ctrl))

    def launch(self, prep: Prepared, dev) -> None:
        """One launch of a prepared entry point, counted."""
        self.launch_one(prep.args, dev)
        if not torch.cuda.is_current_stream_capturing():
            self.by_op[prep.op] += 1

    def gated_rounds(self, ctx, s, pos, bufs: RoundBuffers) -> int:
        """The rounds while a lane is alive or has samples left, in gated
        batches (stages.BodyKernel.gated): the lanes, pos and n_rays
        updated in place; returns the rounds."""
        from ..models import brick  # noqa: PLC0415

        dev = s.alive.device
        ctrl = torch.zeros(N_CTRL, dtype=torch.int64, device=dev)
        ctrl[C_COUNT] = brick.pending_count(ctx, s)
        phase = self.prepare(ctx, "phase_a", s, pos, bufs, ctrl=ctrl)
        sort = lanesort.KERNEL.prepare_brick(bufs, ctrl, ctx.n_bricks)
        rnd = self.prepare(ctx, "round", s, pos, bufs, ctrl=ctrl)

        def chain():
            self.launch(phase, dev)
            lanesort.KERNEL.launch(sort, dev)
            self.sorts += 1
            self.launch(rnd, dev)

        return self.gated(chain, ctrl, 0, 1, dev)


def _check(name, x, width, dev):
    shape = (width, 3) if name in _VEC3 else (width,)
    stages.check_lane("brickbody", name, x, _DTYPES[name], shape, dev)


KERNEL = BrickBodyKernel()


def _rebuilt(op: str, s, out):
    """The state a launch of `op` leaves: `out`'s fields where the entry
    point writes them, `s`'s elsewhere."""
    if out is s:
        return s
    kept = {n: getattr(s, n) for n in STATE_FIELDS
            if n not in WRITES[op] and hasattr(s, n)}
    rng = type(s.rng)(out.rng.state,
                      out.rng.inc if "rng_inc" in WRITES[op] else s.rng.inc)
    return out._replace(rng=rng, n_rays=s.n_rays, **kept)


def phase_a(ctx, s, pos, bufs, out=None, pos_out=None):
    """Phase A of the lane-ordered state `s` at positions `pos`: the plain
    version for CPU tensors, the kernel for CUDA tensors (updating s in
    place, or writing `out` and `pos_out`; perm, keys and the count into
    `bufs`).  Returns (s', keys, perm, count) as plain_phase_a does."""
    dev = s.alive.device
    if dev.type == "cpu":
        return plain_phase_a(ctx, s, pos)
    if dev.type != "cuda":
        raise ValueError(f"brickbody: no kernel for device {dev}")
    n_rays = torch.empty((), dtype=torch.float32, device=dev)
    prep = KERNEL.prepare(ctx, "phase_a", s, pos, bufs, out=out,
                          pos_out=pos_out, n_rays_out=n_rays)
    KERNEL.launch(prep, dev)
    new = _rebuilt("phase_a", s, s if out is None else out)
    return new._replace(n_rays=n_rays), bufs.keys, bufs.perm, bufs.count


def round_(ctx, s, pos, bufs, out=None, pos_out=None):
    """The tracking round of the lane-ordered state `s` at positions `pos`
    on `bufs` (perm from phase A, skeys and order from the sort): the plain
    version for CPU tensors, the kernel for CUDA tensors (updating s and
    pos in place, or writing `out` and `pos_out`).  Returns (s', pos')."""
    dev = s.alive.device
    if dev.type == "cpu":
        return plain_round(ctx, s, pos, bufs.perm, bufs.skeys, bufs.order)
    if dev.type != "cuda":
        raise ValueError(f"brickbody: no kernel for device {dev}")
    prep = KERNEL.prepare(ctx, "round", s, pos, bufs, out=out,
                          pos_out=pos_out)
    KERNEL.launch(prep, dev)
    return (_rebuilt("round", s, s if out is None else out),
            pos if pos_out is None else pos_out)


def one_round(ctx, s, pos, bufs: RoundBuffers):
    """One round (phase A, the sort, the tracking round) by the wrappers,
    ungated: (s', pos').  On the card s and pos are updated in place."""
    s, keys, perm, count = phase_a(ctx, s, pos, bufs)
    if s.alive.device.type == "cpu":
        bufs.perm, bufs.keys, bufs.count = perm, keys, count
        bufs.skeys, bufs.order = torch.sort(keys, stable=True)
    else:
        bufs.sort(n_bricks=ctx.n_bricks)
    return round_(ctx, s, pos, bufs)


def run_rounds(ctx, s, kernel: bool):
    """The rounds while a lane is alive or has samples left, from the
    lane-ordered state `s` with every lane at its own position: gated
    batches of the kernels when `kernel` (on a copy of the state), else the
    plain versions with one host read of the count per round.  Returns
    (s, pos, rounds); the state stays in lane order."""
    from ..models import brick  # noqa: PLC0415

    dev = s.alive.device
    n = s.alive.shape[0]
    pos = torch.arange(n, dtype=torch.int64, device=dev)
    if kernel:
        s = own(s)
        rounds = KERNEL.gated_rounds(ctx, s, pos, RoundBuffers.make(n, dev))
        return s, pos, rounds
    rounds = 0
    while True:
        KERNEL.reads += 1
        if not bool(brick.pending_count(ctx, s)):
            break
        s, keys, perm, _ = plain_phase_a(ctx, s, pos)
        skeys, order = torch.sort(keys, stable=True)
        s, pos = plain_round(ctx, s, pos, perm, skeys, order)
        rounds += 1
    return s, pos, rounds


# -- the bound -----------------------------------------------------------------

#: bytes of each per-lane field (the RNG's two words split)
FIELD_BYTES = dict(o=12, d=12, throughput=12, accum=12, normal=12, base=12,
                   t=4, max_t=4, brick_exit=4, inv_sig=4, pix=8,
                   samples_done=8, status=8, alive=1, tracking=1,
                   rng_state=8, rng_inc=8)
#: bytes per lane of the round's bookkeeping: phase A reads pos (8) and
#: writes perm (8) and a key (4); the round reads the order (8), a sorted
#: key (4) and perm (8) and writes pos (8)
KEYS_BYTES = 8 + 8 + 4
ORDER_BYTES = 8 + 4 + 8 + 8


def brick_bytes(ctx, taps) -> int:
    """The least bytes the launches whose `taps` are given move (the lists
    plain_phase_a and plain_round fill): per lane the fields its branch
    reads and the ones it changes (stages.lane_traffic), the bookkeeping
    of pos, perm, keys and order (KEYS_BYTES, ORDER_BYTES a lane), and the
    distinct words read of the fused grid (4 B, or the 16 B row of a
    'full' grid), of the brick majorants (4 B) and of the dilated brick
    tables (4 B)."""
    n = stages.state_bytes(taps, FIELD_BYTES)
    per = {"keys": KEYS_BYTES, "order": ORDER_BYTES}
    word = {"fused": 16 if ctx.albedo_mode == "full" else 4, "major": 4,
            "table": 4}
    seen = {}
    for kind, x in taps:
        if kind in per:
            n += per[kind] * int(x.sum())
        elif kind in word:
            seen[kind] = torch.cat([seen[kind], x]) if kind in seen else x
    return n + sum(word[k] * int(torch.unique(x).numel())
                   for k, x in seen.items())
