"""The integrator-family schedulers' bodies as CUDA kernels
(csrc/familybody.cu).

On the TPU each scheduler's loop is one `lax.while_loop` that XLA compiled
into one device program: `integrator.trace` over `bounce_step`
(cudavolumerenderer_tpu/models/integrator.py:237, :350), regeneration's
`render_tile` (models/regeneration.py:176, `_regenerate` :30), streaming's
(models/streaming.py:211; `_refill` :64, `extend_step` :217) and the MK
schedulers' dispatches (models/wavefront_mk.py).  The port's eager
functions run each evaluation as hundreds of masked torch launches with
host reads of the loop condition; the kernels run one evaluation of every
lane of a pool per launch, bit for bit the eager function's on the card:

  bounce  integrator.bounce_step (with regenerationSK's fused splat; the
          variable boundary's isosurface march, integrator.py:92, in it),
          one launch per evaluation (naiveMK), in gated chains with the
          refill (regenerationSK's queue stage), or drained (naiveSK's
          trace and regenerationSK's tail: each lane bounces until it
          dies, in one launch);
  refill  regeneration.queue_refill with `_regenerate`'s group rule, and
          streaming._refill's field resets;
  extend  streaming.extend_step (with `defer` sortingSK's stall), in gated
          chains with the refill (the queue stage), or drained (the tail:
          each lane extends until it dies, in one launch, or sortingSK's
          segments between sort points), and flush, streaming.flush_pending.

sortingSK's sort points (streaming._morton_reorder) run between them as
ops/lanesort.py's gated radix sort (csrc/lanesort.cu), the pool permuted in
place so the prepared launches' pointers stay valid.

The queue-fed loops (regenerationSK, streamingSK, sortingSK) run in two
parts: the queue stage while paths are unissued, and the tail from the
iteration e0 at which every path is issued, where a refill takes nothing
and each lane runs alone (`regenerate_tail`, `stream_tail`).

This module holds the gate (`route`), the parameter vectors
(`make_context`), the plain versions (`plain_body`, the eager functions),
the wrapper `run_body` (the plain version for CPU tensors, the kernel for
CUDA tensors, or it raises), the schedulers' loops (`regenerate_loop`,
`stream_loop`: stages.loop_chains of the plain bodies, or gated chains of
the kernels, the sort and the tail drains; `trace`, the drain) and the bound
(`family_bytes`).  The kernels update a pool's per-lane tensors in place
unless given `out`.
"""

from __future__ import annotations

import ctypes
import dataclasses
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ..constants import EPSILON
from . import stages
from .rng import as_u32, jump_constants, mul32
from .stages import (C_COUNT, C_EVAL, C_LEFT, C_LMAX, C_TOTAL, DRAIN_CAP,
                     N_CTRL, lane_field, own)
from .stages import f32 as _f32

_SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "familybody.cu"

# Float parameters (csrc/familybody.cu FP_*).
FP_BMIN = 0
FP_BMAX = FP_BMIN + 3
FP_EXT = FP_BMAX + 3
FP_RMD = FP_EXT + 3
FP_RMA = FP_RMD + 3
FP_SCALE = FP_RMA + 3
FP_INV_SIGMAT = FP_SCALE + 1
FP_G = FP_INV_SIGMAT + 1
FP_LE = FP_G + 1
FP_ROUGH = FP_LE + 3
FP_ETA = FP_ROUGH + 2
FP_INV_ETA = FP_ETA + 1
(FP_TILEX, FP_TILEY, FP_INV_TW, FP_INV_RESX,
 FP_INV_RESY) = range(FP_INV_ETA + 1, FP_INV_ETA + 6)
FP_CAM = FP_INV_RESY + 1  # the camera's (3, 4) inv_view, row-major
FP_R2VX = FP_CAM + 12
FP_R2VY = FP_R2VX + 1
# the variable boundary: min_step, min_step + EPSILON (a Python double sum,
# then float32), the gradient threshold
FP_MINSTEP, FP_MSE, FP_THRESH = range(FP_R2VY + 1, FP_R2VY + 4)
N_FP = FP_THRESH + 1

# Integer parameters (csrc/familybody.cu IP_*).
(IP_OP, IP_NX, IP_NY, IP_NZ, IP_AX, IP_AY, IP_AZ, IP_NCH, IP_NEAREST,
 IP_BSDF, IP_MITSUBA, IP_RR, IP_MAXPATH, IP_SPLAT, IP_DEFER, IP_GROUP,
 IP_STREAM, IP_NPATHS, IP_TW, IP_NPIX, IP_BASE, IP_SEEDH, IP_THRESH,
 IP_CHAIN, IP_CAP, IP_VARIABLE, IP_LOOK, IP_LANES, IP_QUEUE, IP_SEGMENT,
 N_IP) = range(31)
#: a queue-fed loop's control word after stages' N_CTRL: the iteration at
#: which its tail started (csrc/familybody.cu C_E0)
C_E0 = N_CTRL
#: a tail drain's IP_MAXPATH: no bound (the queue-fed loops bound no path,
#: and a tail lane's bounces are not the tail's evaluations)
NO_BOUND = 1 << 62

#: the entry points (IP_OP)
OPS = ("bounce", "refill", "extend", "flush")
#: the tail drains (regenerationSK's over the bounce, streamingSK's and
#: sortingSK's over the extend)
TAILS = ("bounce", "extend")

# Pointer slots (csrc/familybody.cu S_*): the per-lane fields in PathState's
# and StreamState's names (the RNG's two words split), the outputs, then
# the rest.
LANE_FIELDS = ("o", "d", "throughput", "radiance", "alive", "rng_state",
               "rng_inc", "image_id", "tracking", "t", "max_t", "normal",
               "pending", "p_scat")
N_LANE = len(LANE_FIELDS)
PATH_FIELDS = LANE_FIELDS[:7]  # a PathState's
_DTYPES = dict(zip(LANE_FIELDS, (torch.float32,) * 4 + (torch.bool,)
                   + (torch.int64,) * 3 + (torch.bool,) + (torch.float32,) * 3
                   + (torch.bool, torch.float32)))
_VEC3 = ("o", "d", "throughput", "radiance", "normal", "p_scat")
S_OUT = N_LANE
(S_NRAYS, S_NRAYS_OUT, S_COUNT, S_ISSUED, S_ISSUED_OUT, S_ACCUM, S_DENSITY,
 S_ALBEDO, S_SCRATCH, S_STATUS, S_CTRL, S_HIST, S_JUMP) = range(
     S_OUT + N_LANE, S_OUT + N_LANE + 13)
N_S = S_JUMP + 1
N_SCRATCH = 5  # csrc/familybody.cu SC_*
REFILL_BLOCK = 1024  # lanes per refill block (its look-back word)
#: the lookahead groups' sizes csrc/familybody.cu builds (threads): those
#: the width rule takes (chip_smoke.family_sweep also timed 4 and 32)
GROUPS = (1, 8, 16)
GROUP_MAX = GROUPS[-1]


def lookahead(width: int) -> tuple:
    """(G, M): the bounce's lookahead group for a pool of `width` lanes
    (bounce_kernel and the drain).  G threads hold M lanes, each lane on
    G / M threads that compute its bounce alike, and take their lanes'
    Woodcock chains in turn, G steps a round (csrc/familybody.cu).

    Fewer threads a lane as the pool widens: measured on the H100 by
    chip_smoke.family_sweep (PERF.md), G 16 with one lane at 4,096
    lanes (smoke and medical pools both), then M doubling with every
    doubling of the width up to 16 lanes at 131,072, where the medical
    row's whole regenerationSK render needs no redundant thread (G 16 / M 8
    took 23.1 ms of bounces against 19.8 ms at M 16 and 20.2 ms at one
    thread without lookahead); G 8 / M 8 on the naiveSK drains of 160,000
    to 640,000 lanes; and one thread a lane without lookahead above, where
    the medical drain waits on a lane of 1,000 bounces that a group only
    slows (5.25 ms at G 1 against 5.77-6.04 ms).  G 4 and 32 were never
    the fastest, so the kernel builds 1, 8 and 16 (GROUPS)."""
    if width <= 131072:
        m = 1
        while m < 16 and 2 * m * 8192 <= width:
            m *= 2
        return 16, m
    if width <= 655360:
        return 8, 8
    return 1, 1


def tail_lookahead(width: int) -> tuple:
    """(G, M): the lookahead group of regenerationSK's tail drain on a pool
    of `width` lanes (drain_kernel from the iteration at which the queue is
    empty).

    The width rule's group below 2^17 lanes, and one thread a lane without
    lookahead from 2^17 up.  The winner follows the tail's length, which
    no launch knows before the tail has run; the width stands in for it,
    and the rule loses on short tails at 2^17.  Measured on the H100 by
    chip_smoke.family_sweep's tails (PERF.md), all at 2^17 lanes: the
    medical class's tail (55,270 alive at e0, its longest lane 1,580
    bounces) 4.85-4.89 ms at G 1 against 5.80-6.33 ms in every group (a
    group only slows the one long lane, as in naiveSK's drain of 2^20
    lanes); the short tails lose at G 1: bucky's (20 bounces) 0.41-0.48 ms
    against 0.35-0.39 at G 16 M 16 or G 8 M 8, the smoke class's (6)
    0.39-0.43 against 0.31-0.35 at G 16 M 16, and phase 11's rows, which
    render at 131,072 lanes (occupancy.pick_n_lanes), 0.43 ms against
    0.25-0.27 at G 8 M 4 or G 16 M 8 (6 bounces).  So G 1 gains ~1 ms on
    the long tail and costs 0.06-0.18 ms on a short one."""
    if width >= 131072:
        return 1, 1
    return lookahead(width)


#: the fields each entry point writes
WRITES = {
    "bounce": ("o", "d", "throughput", "radiance", "alive", "rng_state"),
    "refill": ("o", "d", "throughput", "radiance", "alive", "rng_state",
               "rng_inc", "image_id", "tracking"),
    "extend": ("o", "d", "throughput", "radiance", "alive", "rng_state",
               "tracking", "t", "max_t", "normal", "pending", "p_scat"),
    "flush": ("throughput", "radiance", "alive", "rng_state", "pending"),
}


def route(device_type: str, eager_body: bool = False) -> bool:
    """Whether a scheduler's bodies go to the kernels: on the card (for
    either boundary model: the bounce runs the variable boundary's march),
    unless the caller asks for the eager bodies (tests and chip_smoke.py
    hold the kernels against them).  The CPU has no kernel."""
    return device_type == "cuda" and not eager_body


@dataclasses.dataclass
class FamilyContext:
    """A render's body inputs besides the pool: what the eager functions
    take (the plain versions') and, built at the first launch, the kernel's
    parameter vectors (host numpy)."""

    scene: object
    settings: object
    camera: object = None
    tile_dim: tuple = (1, 1)
    tile_offset: Optional[torch.Tensor] = None
    full_resolution: tuple = (1, 1)
    n_paths: int = 0
    seed: object = 0
    path_id_base: object = 0
    group: int = 1  # _regenerate's refill group
    _params: Optional[tuple] = None

    def params(self):
        """(fparams, iparams, density, albedo) for the kernel, read back
        once from the tensors the eager functions use.  A division by a
        Python scalar runs on the card as a multiplication by the scalar's
        float32 reciprocal, so those reciprocals are what the vector holds."""
        if self._params is None:
            self._params = _kernel_params(self)
        return self._params


def make_context(scene, settings, camera=None, tile_dim=(1, 1),
                 tile_offset=None, full_resolution=(1, 1), n_paths: int = 0,
                 seed=0, path_id_base=0, group: int = 1) -> FamilyContext:
    """The context of one render_tile call (a refill needs the camera and
    the tile's queue, a bounce or an extend only the scene)."""
    if tile_offset is None:
        tile_offset = torch.zeros(2, dtype=torch.float32, device=scene.device)
    return FamilyContext(scene, settings, camera, tuple(tile_dim),
                         tile_offset, tuple(full_resolution), int(n_paths),
                         seed, path_id_base, int(group))


def _kernel_params(ctx: FamilyContext):
    from . import woodcock  # noqa: PLC0415

    scene, settings = ctx.scene, ctx.settings
    if settings.interpolation not in ("trilinear", "nearest"):
        raise ValueError(f"unknown interpolation {settings.interpolation!r}")
    med = scene.medium
    dens, alb = med.density.data, med.albedo.data
    if dens.ndim != 3 or alb.ndim != 4 or alb.shape[3] == 2:
        raise ValueError("familybody: the density is (Z, Y, X) and the "
                         "albedo (Z, Y, X, C) with C = 1 or C >= 3")
    g = ctx.group
    if g < 1 or g > REFILL_BLOCK or g & (g - 1):
        raise ValueError(f"familybody: a refill group is a power of two up "
                         f"to {REFILL_BLOCK}, not {g}")
    f = np.zeros(N_FP, np.float32)
    i = np.zeros(N_IP, np.int64)
    one = np.float32(1.0)
    extent = med.box_max - med.box_min
    inv_sigmat, _ = woodcock._inv_sigmat(med.scale, med.max_density,
                                         dens.device)
    f[FP_BMIN:FP_BMIN + 3] = _f32(med.box_min)
    f[FP_BMAX:FP_BMAX + 3] = _f32(med.box_max)
    f[FP_EXT:FP_EXT + 3] = _f32(extent)
    nz, ny, nx = dens.shape
    az, ay, ax, nch = alb.shape
    f[FP_RMD:FP_RMD + 3] = (nx - 1, ny - 1, nz - 1)
    f[FP_RMA:FP_RMA + 3] = (ax - 1, ay - 1, az - 1)
    f[FP_SCALE] = _f32(med.scale)[0]
    f[FP_INV_SIGMAT] = _f32(inv_sigmat)[0]
    f[FP_G] = _f32(med.g)[0]
    f[FP_LE:FP_LE + 3] = _f32(scene.le)
    f[FP_ROUGH:FP_ROUGH + 2] = _f32(scene.bsdf.roughness)
    f[FP_ETA] = _f32(scene.bsdf.eta)[0]
    f[FP_INV_ETA] = one / f[FP_ETA]
    tw, th = ctx.tile_dim
    f[FP_MINSTEP] = settings.boundary_min_step
    f[FP_MSE] = settings.boundary_min_step + EPSILON
    f[FP_THRESH] = settings.boundary_threshold
    f[FP_TILEX:FP_TILEY + 1] = _f32(ctx.tile_offset)
    f[FP_INV_TW] = one / np.float32(tw)
    f[FP_INV_RESX] = one / np.float32(float(ctx.full_resolution[0]))
    f[FP_INV_RESY] = one / np.float32(float(ctx.full_resolution[1]))
    if ctx.camera is not None:
        f[FP_CAM:FP_CAM + 12] = _f32(ctx.camera.inv_view)
        f[FP_R2VX:FP_R2VY + 1] = _f32(ctx.camera.raster_to_view)
    i[IP_NX], i[IP_NY], i[IP_NZ] = nx, ny, nz
    i[IP_AX], i[IP_AY], i[IP_AZ], i[IP_NCH] = ax, ay, az, nch
    i[IP_NEAREST] = int(settings.interpolation == "nearest")
    i[IP_BSDF] = int(settings.bsdf_kind == "ggx")
    i[IP_MITSUBA] = int(settings.mitsuba_comparable)
    i[IP_RR] = int(settings.russian_roulette)
    i[IP_MAXPATH] = settings.max_path_length
    i[IP_VARIABLE] = int(settings.boundary == "variable")
    i[IP_GROUP] = g
    i[IP_NPATHS] = ctx.n_paths
    i[IP_TW], i[IP_NPIX] = tw, tw * th
    base = ctx.path_id_base
    i[IP_BASE] = int(as_u32(base, "cpu")) if not isinstance(
        base, torch.Tensor) else int(as_u32(base).cpu())
    seed = ctx.seed if isinstance(ctx.seed, torch.Tensor) else int(ctx.seed)
    i[IP_SEEDH] = int(mul32(as_u32(seed, "cpu").cpu(), 0x9E3779B9))
    density = dens.contiguous()
    albedo = alb.contiguous()
    return f, i, density, albedo


# -- the plain versions --------------------------------------------------------

def plain_body(ctx: FamilyContext, op: str, s, image_id=None, accum=None,
               issued=None, defer: bool = False, taps=None):
    """One evaluation of the entry point `op` by its plain version (the
    eager torch function), on any device; counted in KERNEL.plain_evals.
    Returns what run_body returns, with None for the count.  A list given
    as `taps` receives the evaluation's traffic (family_bytes)."""
    from ..models import integrator, regeneration, streaming  # noqa: PLC0415

    KERNEL.plain_evals[op] += 1
    scene, settings = ctx.scene, ctx.settings
    if op == "bounce":
        was = s.alive
        s = integrator.bounce_step(scene, settings, s, taps=taps)
        if accum is not None:
            # regeneration.render_tile's splat of the lanes that died
            died = torch.logical_and(was, torch.logical_not(s.alive))
            accum.index_add_(
                0, image_id, torch.where(died[..., None], s.radiance, 0.0))
            rad = torch.where(died[..., None], 0.0, s.radiance)
            if taps is not None:
                taps += [("accum", image_id[died]), ("state", {
                    "radiance": (died, stages.changed(s.radiance, rad)),
                    "image_id": (died, torch.zeros_like(died))})]
            s = s._replace(radiance=rad)
        return s, None
    if op == "refill":
        queue = (ctx.n_paths, ctx.tile_dim, ctx.tile_offset,
                 ctx.full_resolution, ctx.camera, ctx.seed, ctx.path_id_base)
        stream = isinstance(s, streaming.StreamState)
        if stream:
            new, issued = streaming._refill(s, issued, *queue)
            img = new.image_id
        else:
            new, img, issued = regeneration._regenerate(
                s, image_id, issued, *queue, refill_group=ctx.group)
        if taps is not None:
            # a refill reads the alive flags alone
            names = LANE_FIELDS if stream else PATH_FIELDS
            none = torch.zeros_like(s.alive)
            reads = {n: none for n in names}
            reads["alive"] = torch.ones_like(s.alive)
            traffic = stages.lane_traffic(s, new, reads, names)
            if not stream:
                traffic["image_id"] = (none, stages.changed(image_id, img))
            taps.append(("state", traffic))
        return new, img, issued
    if op == "extend":
        s, _ = streaming.extend_step(scene, settings, s, accum,
                                     defer_albedo=defer, taps=taps)
        return s, None
    if op == "flush":
        s, _ = streaming.flush_pending(scene, settings, s, accum, taps=taps)
        return s, None
    raise ValueError(f"familybody: no entry point {op!r}")


# -- the kernels ---------------------------------------------------------------

@dataclasses.dataclass
class Prepared:
    """The arguments of one launch of an entry point, and the host arrays
    and tensors they point at (kept alive with them)."""

    op: str
    args: tuple
    keep: tuple


class FamilyBodyKernel(stages.BodyKernel):
    """The CUDA family kernels, built from csrc/familybody.cu at first use
    and counted (stages.BodyKernel): `by_op` counts each entry point's
    launches made now (a gated one may return untouched), `drain_launches`
    the drains' (the tails' included), `tails` the tail drains' by
    the entry point they drain, `plain_evals` each entry point's
    evaluations by its plain version, `evals` the schedulers' loop
    evaluations (a bounce or an extend of the pool: the host's wavefront
    passes), kernel or plain; `last_split` holds the last queue-fed loop's
    e0 and trip count E."""

    def __init__(self):
        super().__init__("familybody", _SOURCE, (N_FP, N_IP, N_S, N_CTRL))
        self._jumps = {}
        self.reset()

    def reset(self) -> None:
        """Every count to 0."""
        self.launches = self.captured = self.drain_launches = self.reads = 0
        self.enqueue_s = 0.0
        self.evals = 0
        self.by_op = dict.fromkeys(OPS, 0)
        self.plain_evals = dict.fromkeys(OPS, 0)
        self.tails = dict.fromkeys(TAILS, 0)
        self.last_split = None

    def prepare(self, ctx: FamilyContext, op: str, s, *, out=None,
                image_id=None, accum=None, issued=None, issued_out=None,
                n_rays_out=None, count=None, ctrl=None, hist=None,
                defer: bool = False, chain: int = 1, cap: int = 0,
                queue: bool = False, segment: bool = False,
                bound: bool = True, look=None) -> Prepared:
        """The checked arguments of launches of `op` on the pool `s` (a
        PathState, with `image_id` for a refill or a splat, or a
        StreamState) that write `out`'s per-lane fields (s's when None),
        n_rays to `n_rays_out`, the count to `count` (0-d int64), and
        paths_issued from `issued` to `issued_out`; gated on `ctrl` when
        given (chain `chain`, threshold 0); `hist` the drain's histogram.
        `queue`: the count is the paths not yet issued (a queue stage);
        `segment`: the extend drain as a gated segment; `bound` False: the
        drain bounds no path; `look`: the bounce's (G, M) (else
        lookahead's)."""
        fparams, iparams0, density, albedo = ctx.params()
        out = s if out is None else out
        dev = s.alive.device
        width = s.alive.shape[0]
        stream = hasattr(s, "tracking")
        if op in ("extend", "flush") and not stream:
            raise ValueError(f"familybody: {op} runs on a StreamState")
        names = LANE_FIELDS if stream else PATH_FIELDS
        fields = {n: lane_field(s, n) for n in names}
        outs = {n: lane_field(out, n) for n in names}
        if not stream and image_id is not None:
            fields["image_id"] = image_id
            outs["image_id"] = image_id
        if (op == "refill" or accum is not None) and "image_id" not in fields:
            raise ValueError(f"familybody: {op} needs the lanes' image_id")
        for name, x in fields.items():
            _check(name, x, width, dev)
            y = outs[name]
            if y is not x:
                _check(name, y, width, dev)
                if stages.overlaps(x, y):
                    raise ValueError(
                        f"familybody: out.{name} overlaps the input partly")
        for name, x in (("density", density), ("albedo", albedo),
                        ("accum", accum)):
            if x is not None and (x.device != dev or x.dtype != torch.float32
                                  or not x.is_contiguous()):
                raise ValueError(f"familybody: {name} must be contiguous "
                                 f"float32 on {dev}")
        if accum is not None and (accum.ndim != 2 or accum.shape[1] != 3):
            raise ValueError("familybody: accum must be (pixels, 3)")
        if op == "refill" and (ctx.camera is None or issued is None):
            raise ValueError("familybody: a refill needs the camera and "
                             "paths_issued")
        for name, x in (("n_rays", s.n_rays), ("n_rays_out", n_rays_out)):
            if x is not None and (x.device != dev or x.dtype != torch.float32
                                  or x.ndim != 0):
                raise ValueError(f"familybody: {name} must be a 0-d float32 "
                                 f"tensor on {dev}")
        for name, x in (("issued", issued), ("issued_out", issued_out),
                        ("count", count)):
            if x is not None and (x.device != dev or x.dtype != torch.int64
                                  or x.numel() != 1):
                raise ValueError(f"familybody: {name} must be a 0-d int64 "
                                 f"tensor on {dev}")
        iparams = iparams0.copy()
        iparams[IP_OP] = OPS.index(op)
        iparams[IP_SPLAT] = int(accum is not None)
        iparams[IP_DEFER] = int(defer)
        iparams[IP_STREAM] = int(stream)
        iparams[IP_CHAIN], iparams[IP_CAP] = chain, cap
        iparams[IP_LOOK], iparams[IP_LANES] = look or lookahead(width)
        iparams[IP_QUEUE], iparams[IP_SEGMENT] = int(queue), int(segment)
        if not bound:
            iparams[IP_MAXPATH] = NO_BOUND
        ptrs = [0] * N_S
        for name, x in fields.items():
            ptrs[LANE_FIELDS.index(name)] = x.data_ptr()
            ptrs[S_OUT + LANE_FIELDS.index(name)] = outs[name].data_ptr()
        ptrs[S_NRAYS] = s.n_rays.data_ptr()
        ptrs[S_NRAYS_OUT] = (s.n_rays if n_rays_out is None
                             else n_rays_out).data_ptr()
        nblocks = -(-width // REFILL_BLOCK)
        for slot, x in (
                (S_COUNT, count), (S_ISSUED, issued),
                (S_ISSUED_OUT, issued if issued_out is None else issued_out),
                (S_ACCUM, accum), (S_DENSITY, density), (S_ALBEDO, albedo),
                (S_SCRATCH, self.zeros("scratch", N_SCRATCH, torch.int64,
                                       dev)),
                (S_STATUS, self.zeros("status", nblocks, torch.int64, dev)
                 if op == "refill" else None),
                (S_CTRL, ctrl), (S_HIST, hist),
                (S_JUMP, self.jump_table(dev) if op == "bounce" else None)):
            ptrs[slot] = 0 if x is None else x.data_ptr()
        addresses = (ctypes.c_void_p * N_S)(*ptrs)
        return Prepared(op, self.args(fparams, iparams, addresses, width),
                        (fparams, iparams, addresses, density, albedo))

    def jump_table(self, dev) -> torch.Tensor:
        """The bounce's PCG jump table on `dev` (rng.jump_constants: the
        state after m draws, m = 0 .. 2 * GROUP_MAX), made once."""
        if dev not in self._jumps:
            self._jumps[dev] = jump_constants(2 * GROUP_MAX).to(dev)
        return self._jumps[dev]

    def chase_ms(self, n: int, steps: int, seed: int = 0) -> float:
        """Milliseconds per dependent load on the card: one thread follows
        a random cycle through n int32 words (chase_kernel), `steps` loads
        timed by CUDA events after a warm-up pass.  Not on a render's
        path: phase 25's chain bound."""
        dev = torch.device("cuda")
        g = torch.Generator(device="cpu").manual_seed(seed)
        perm = torch.randperm(n, generator=g)
        nxt = torch.empty(n, dtype=torch.int32)
        nxt[perm] = torch.roll(perm, -1).to(torch.int32)
        nxt, out = nxt.to(dev), torch.empty(1, dtype=torch.int32, device=dev)
        fn = self._entry(self.library(), "chase")
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
        stream = torch.cuda.current_stream(dev).cuda_stream
        self._raise(fn(nxt.data_ptr(), n, out.data_ptr(), stream), "chase")
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        self._raise(fn(nxt.data_ptr(), steps, out.data_ptr(), stream),
                    "chase")
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop) / steps

    def launch(self, prep: Prepared, dev) -> None:
        """One launch of a prepared entry point, counted."""
        self.launch_one(prep.args, dev)
        if not torch.cuda.is_current_stream_capturing():
            self.by_op[prep.op] += 1

    def launch_segment(self, prep: Prepared, dev) -> None:
        """One gated launch of a prepared extend drain segment, counted
        (drain_launches, tails["extend"])."""
        fn = self._entry(self.library(), "drain")
        with torch.cuda.device(dev):
            self._raise(fn(*prep.args, torch.cuda.current_stream(
                dev).cuda_stream), "drain")
        self.drain_launches += 1
        self.tails["extend"] += 1

    def body(self, ctx: FamilyContext, op: str, s, *, out=None,
             image_id=None, accum=None, issued=None, defer: bool = False):
        """One evaluation of `op` on the pool `s` (updated in place, or into
        `out`): what run_body returns."""
        dev = s.alive.device
        out = s if out is None else out
        if op == "refill":
            issued_out = torch.empty((), dtype=torch.int64, device=dev)
            prep = self.prepare(ctx, op, s, out=out, image_id=image_id,
                                issued=issued, issued_out=issued_out)
            self.launch(prep, dev)
            new = _rebuilt(op, s, out)
            return (new, new.image_id if hasattr(new, "image_id")
                    else image_id, issued_out)
        n_rays = torch.empty((), dtype=torch.float32, device=dev)
        count = torch.empty((), dtype=torch.int64, device=dev)
        prep = self.prepare(ctx, op, s, out=out, image_id=image_id,
                            accum=accum, n_rays_out=n_rays, count=count,
                            defer=defer)
        self.launch(prep, dev)
        new = _rebuilt(op, s, out)
        if op == "flush":
            return new, None
        return new._replace(n_rays=n_rays), count

    def drain(self, ctx: FamilyContext, s, cap: int = DRAIN_CAP):
        """integrator.trace: every lane bounces until it dies or reaches
        max_path_length, drained (stages.BodyKernel.drain); the pool's
        per-lane tensors are updated in place and its n_rays is fresh.
        last_drain holds the longest lane's bounces."""
        dev = s.alive.device
        s = s._replace(n_rays=s.n_rays.clone())
        ctrl = torch.zeros(N_CTRL, dtype=torch.int64, device=dev)
        hist = self.zeros("hist", cap + 1, torch.int64, dev)
        prep = self.prepare(ctx, "bounce", s, ctrl=ctrl, hist=hist, cap=cap)
        super().drain(prep.args, (), ctrl, dev)
        return s

    def _queue_ctrl(self, ctx: FamilyContext, issued, e0, dev):
        """A queue-fed loop's control words (N_CTRL, then C_E0: the
        iteration at which its tail started): from iteration 0, the count
        the paths not yet issued (e0 None), or kept at e0, where the queue
        stage has stopped."""
        ctrl = torch.zeros(N_CTRL + 1, dtype=torch.int64, device=dev)
        if e0 is None:
            ctrl[C_COUNT] = ctx.n_paths - issued
        else:
            ctrl[C_EVAL] = e0
        return ctrl

    def _regen_chain(self, ctx: FamilyContext, s, image_id, issued, accum,
                     ctrl):
        """One iteration of regenerationSK's queue stage: a gated refill and
        a gated bounce with the splat, which leaves the stage's count (the
        paths not yet issued)."""
        dev = s.alive.device
        refill = self.prepare(ctx, "refill", s, image_id=image_id,
                              issued=issued, ctrl=ctrl)
        bounce = self.prepare(ctx, "bounce", s, image_id=image_id,
                              accum=accum, issued=issued,
                              count=ctrl[C_COUNT], ctrl=ctrl, queue=True)

        def chain():
            self.launch(refill, dev)
            self.launch(bounce, dev)

        return chain

    def regenerate(self, ctx: FamilyContext, s, image_id, issued, accum,
                   e0=None, cap: int = DRAIN_CAP) -> tuple:
        """regeneration.render_tile's loop (stages.BodyKernel.queued): the
        queue stage's gated chains of a refill and a bounce, the tail
        drain (drain_kernel with the splat and no path bound) behind each
        batch; or, on a pool kept at e0 (every path issued), the tail
        alone.  The pool, image_id, paths_issued and n_rays updated in
        place.  Returns (e0, the loop's trip count)."""
        dev = s.alive.device
        ctrl = self._queue_ctrl(ctx, issued, e0, dev)
        chain = (None if e0 is not None else
                 self._regen_chain(ctx, s, image_id, issued, accum, ctrl))
        drain = self.prepare(
            ctx, "bounce", s, image_id=image_id, accum=accum, ctrl=ctrl,
            hist=self.zeros("hist", cap + 1, torch.int64, dev), cap=cap,
            bound=False, queue=True, look=tail_lookahead(s.alive.shape[0]))
        words = self.queued(chain, drain.args, ctrl, 1, dev)
        self.tails["bounce"] += self.last_drain["launches"]
        return words[C_E0], words[C_TOTAL]

    def regenerate_queue(self, ctx: FamilyContext, s, image_id, issued,
                         accum) -> int:
        """regeneration.render_tile's queue stage alone (gated chains), the
        pool kept at e0: the pool, image_id, paths_issued and n_rays
        updated in place.  Returns e0 (read from the card)."""
        dev = s.alive.device
        ctrl = self._queue_ctrl(ctx, issued, None, dev)
        chain = self._regen_chain(ctx, s, image_id, issued, accum, ctrl)
        return self.gated(chain, ctrl, 0, 1, dev)

    def _stream_chain(self, ctx: FamilyContext, s, issued, accum, ctrl, *,
                      sort_every: int, defer: bool, k_chain: int, reorder):
        """One chain of k_chain iterations of streaming's queue stage: each
        a gated refill and a gated extend, which leaves the stage's count
        (the paths not yet issued), after the gated Morton sort in place
        (`reorder(s, ctrl, k_chain)` prepares it) and with `defer` a gated
        flush every sort_every iterations of the host's counter."""
        dev = s.alive.device
        sort = reorder(s, ctrl, k_chain) if sort_every > 0 else None
        flush = self.prepare(ctx, "flush", s, accum=accum, ctrl=ctrl,
                             chain=k_chain)
        refill = self.prepare(ctx, "refill", s, issued=issued, ctrl=ctrl,
                              chain=k_chain)
        extend = self.prepare(ctx, "extend", s, accum=accum, issued=issued,
                              count=ctrl[C_COUNT], ctrl=ctrl, defer=defer,
                              chain=k_chain, queue=True)
        it = 0

        def chain():
            nonlocal it
            for _ in range(k_chain):
                if sort_every > 0 and it % sort_every == 0:
                    sort()
                    if defer:
                        self.launch(flush, dev)
                self.launch(refill, dev)
                self.launch(extend, dev)
                it += 1

        return chain

    def stream(self, ctx: FamilyContext, s, issued, accum, *,
               sort_every: int, defer: bool, k_chain: int, reorder,
               e0=None, cap: int = DRAIN_CAP) -> tuple:
        """streaming.render_tile's loop: without a sort, queued
        (stages.BodyKernel.queued: the queue stage's gated chains, the
        extend drain behind each batch); with one, the queue stage's gated
        chains and then the sorted tail (_sorted_tail).  On a pool kept at
        e0 (a multiple of k_chain, every path issued), the tail alone.  The
        pool, paths_issued and n_rays updated in place.  Returns (e0, the
        loop's trip count)."""
        dev = s.alive.device
        kw = dict(sort_every=sort_every, defer=defer, k_chain=k_chain,
                  reorder=reorder)
        if sort_every > 0:
            if e0 is None:
                e0 = self.stream_queue(ctx, s, issued, accum, **kw)
            return e0, self._sorted_tail(ctx, s, accum, e0, **kw)
        ctrl = self._queue_ctrl(ctx, issued, e0, dev)
        chain = (None if e0 is not None else
                 self._stream_chain(ctx, s, issued, accum, ctrl, **kw))
        drain = self.prepare(
            ctx, "extend", s, accum=accum, ctrl=ctrl,
            hist=self.zeros("hist", cap + 1, torch.int64, dev), cap=cap,
            chain=k_chain, defer=defer, queue=True)
        words = self.queued(chain, drain.args, ctrl, k_chain, dev)
        self.tails["extend"] += self.last_drain["launches"]
        return words[C_E0], words[C_TOTAL]

    def stream_queue(self, ctx: FamilyContext, s, issued, accum, *,
                     sort_every: int, defer: bool, k_chain: int,
                     reorder) -> int:
        """streaming.render_tile's queue stage alone (gated chains of k_chain
        iterations), the pool kept at e0: the pool, paths_issued and n_rays
        updated in place.  Returns e0 (a multiple of k_chain, read from the
        card)."""
        dev = s.alive.device
        ctrl = self._queue_ctrl(ctx, issued, None, dev)
        chain = self._stream_chain(ctx, s, issued, accum, ctrl,
                                   sort_every=sort_every, defer=defer,
                                   k_chain=k_chain, reorder=reorder)
        return self.gated(chain, ctrl, 0, k_chain, dev)

    def _sorted_tail(self, ctx: FamilyContext, s, accum, e0: int, *,
                     sort_every: int, defer: bool, k_chain: int,
                     reorder) -> int:
        """sortingSK's tail on a pool at e0 (a multiple of k_chain): gated
        chains of k_chain evaluations whose sort points run the gated
        Morton sort (`reorder(s, ctrl, k_chain)` prepares it) and the flush
        as the loop does, each run of evaluations up to the next sort point
        one gated extend_drain_kernel segment.  The pool and n_rays updated
        in place.  Returns the loop's trip count."""
        dev = s.alive.device
        ctrl = torch.zeros(N_CTRL + 1, dtype=torch.int64, device=dev)
        ctrl[C_EVAL] = e0
        ctrl[C_COUNT] = torch.count_nonzero(s.alive)
        sort = reorder(s, ctrl, k_chain)
        flush = self.prepare(ctx, "flush", s, accum=accum, ctrl=ctrl,
                             chain=k_chain)
        hist = self.zeros("hist", k_chain + 1, torch.int64, dev)
        segments = {}
        it = e0

        def segment(n):
            if n not in segments:
                segments[n] = self.prepare(
                    ctx, "extend", s, accum=accum, ctrl=ctrl, hist=hist,
                    cap=n, chain=k_chain, defer=defer, segment=True)
            return segments[n]

        def chain():
            nonlocal it
            end = it + k_chain
            while it < end:
                if it % sort_every == 0:
                    sort()
                    if defer:
                        self.launch(flush, dev)
                nxt = min(end, (it // sort_every + 1) * sort_every)
                self.launch_segment(segment(nxt - it), dev)
                it = nxt

        return self.gated(chain, ctrl, 0, k_chain, dev)


def _rebuilt(op: str, s, out):
    """The pool a launch of `op` leaves: `out`'s fields where the entry
    point writes them (a PathState's image_id is written in place), `s`'s
    elsewhere."""
    if out is s:
        return s
    kept = {n: getattr(s, n) for n in LANE_FIELDS
            if n not in WRITES[op] and hasattr(s, n)}
    rng = out.rng if op == "refill" else type(s.rng)(out.rng.state, s.rng.inc)
    return out._replace(rng=rng, n_rays=s.n_rays, **kept)


def _check(name, x, width, dev):
    shape = (width, 3) if name in _VEC3 else (width,)
    stages.check_lane("familybody", name, x, _DTYPES[name], shape, dev)


KERNEL = FamilyBodyKernel()


def run_body(ctx: FamilyContext, op: str, s, image_id=None, accum=None,
             issued=None, defer: bool = False, out=None):
    """One evaluation of the entry point `op` on the pool `s`: the plain
    version for CPU tensors, the CUDA kernel for CUDA tensors.  Returns
    (s', count) for a bounce or an extend (count: the pool's alive count
    as a 0-d int64 tensor, or None when the plain version ran),
    (s', image_id', paths_issued') for a refill, (s', None) for a flush.
    A kernel updates the pool's per-lane tensors in place (or writes
    `out`'s); `accum` takes the splat in place."""
    dev = s.alive.device
    if dev.type == "cpu":
        return plain_body(ctx, op, s, image_id=image_id, accum=accum,
                          issued=issued, defer=defer)
    if dev.type == "cuda":
        return KERNEL.body(ctx, op, s, out=out, image_id=image_id,
                           accum=accum, issued=issued, defer=defer)
    raise ValueError(f"familybody: no kernel for device {dev}")


# -- the schedulers' loops -----------------------------------------------------

def copy_lanes_(dst, src) -> None:
    """Copy the pool `src`'s per-lane fields into `dst`'s tensors (a
    permutation of the lanes, so the kernels' pointers stay valid)."""
    for name in LANE_FIELDS if hasattr(dst, "tracking") else PATH_FIELDS:
        lane_field(dst, name).copy_(lane_field(src, name))


def trace(ctx: FamilyContext, s, kernel: bool):
    """integrator.trace (lanes bounce until none is alive, at most
    max_path_length bounces): the drain (one launch) when `kernel`, else
    the loop of plain bounces, the alive flags read once per bounce."""
    if kernel:
        s = KERNEL.drain(ctx, own(s))
        KERNEL.evals += KERNEL.last_drain["E"]
        return s
    bounce = 0
    while bounce < ctx.settings.max_path_length:
        KERNEL.reads += 1
        if not bool(torch.any(s.alive)):
            break
        s, _ = plain_body(ctx, "bounce", s)
        bounce += 1
    KERNEL.evals += bounce
    return s


def _queue_count(ctx: FamilyContext, issued) -> int:
    """A queue stage's count: the paths not yet issued (one host read)."""
    return ctx.n_paths - int(issued)


def _alive_count(s) -> int:
    """A tail's count: the lanes alive (one host read)."""
    return int(torch.count_nonzero(s.alive))


def regenerate_loop(ctx: FamilyContext, s, image_id, issued, accum,
                    kernel: bool):
    """regeneration.render_tile's loop (refill, then a bounce that splats
    the lanes it ends, while a lane is alive or a path unissued) as a queue
    stage while paths are unissued and the tail from the iteration e0 at
    which every path is issued (regenerate_tail): gated chains of the
    kernels and the tail drain when `kernel`, else stages.loop_chains of
    the plain versions.  On the card the tail drain is enqueued behind
    each batch of the queue stage (stages.BodyKernel.queued).  Returns
    (pool, evaluations)."""
    if kernel:
        s, image_id, issued = own(s), image_id.clone(), issued.clone()
        e0, n = KERNEL.regenerate(ctx, s, image_id, issued, accum)
        KERNEL.last_split = {"e0": e0, "E": n}
    else:
        s, image_id, issued, e0 = regenerate_queue(ctx, s, image_id, issued,
                                                   accum, False)
        s, n = regenerate_tail(ctx, s, image_id, issued, accum, e0, False)
    KERNEL.evals += n
    return s, n


def regenerate_queue(ctx: FamilyContext, s, image_id, issued, accum,
                     kernel: bool):
    """regeneration.render_tile's loop from iteration 0 while paths are
    unissued: gated chains of the kernels when `kernel` (on copies of the
    pool, image_id and paths_issued), else stages.loop_chains of the plain
    versions.  Returns (pool, image_id, paths_issued, e0): e0 the iteration
    after the one that issued the last path."""
    if kernel:
        s, image_id, issued = own(s), image_id.clone(), issued.clone()
        e0 = KERNEL.regenerate_queue(ctx, s, image_id, issued, accum)
        return s, image_id, issued, e0
    (s, image_id, issued), e0 = stages.loop_chains(
        KERNEL, (s, image_id, issued), lambda c: _queue_count(ctx, c[2]),
        _regen_body(ctx, accum), 0, 1)
    return s, image_id, issued, e0


def regenerate_tail(ctx: FamilyContext, s, image_id, issued, accum, e0: int,
                    kernel: bool):
    """regeneration.render_tile's loop from iteration e0, at which every
    path is issued (a refill then takes nothing, so each lane bounces alone
    until it dies): the tail drain when `kernel` (s's tensors, which must
    be its own, updated in place), else the eager loop of plain refills
    and bounces while a lane is alive.  Returns (pool, the loop's trip
    count)."""
    if kernel:
        _, n = KERNEL.regenerate(ctx, s, image_id, issued, accum, e0)
        KERNEL.last_split = {"e0": e0, "E": n}
        return s, n
    (s, _, _), n = stages.loop_chains(
        KERNEL, (s, image_id, issued), lambda c: _alive_count(c[0]),
        _regen_body(ctx, accum), 0, 1)
    KERNEL.last_split = {"e0": e0, "E": e0 + n}
    return s, e0 + n


def _regen_body(ctx: FamilyContext, accum):
    """The eager loop's iteration on (pool, image_id, paths_issued): a
    refill, then a bounce that splats the lanes it ends."""
    def body(c):
        p, img, iss = plain_body(ctx, "refill", c[0], image_id=c[1],
                                 issued=c[2])
        p, _ = plain_body(ctx, "bounce", p, image_id=img, accum=accum)
        return (p, img, iss), None

    return body


def stream_loop(ctx: FamilyContext, s, issued, accum, *, sort_every: int,
                defer: bool, check_every: int, kernel: bool):
    """streaming.render_tile's loop (chains of check_every iterations while
    a lane is alive or a path unissued; each iteration a refill and an
    extend, after the Morton sort and with `defer` the flush every
    sort_every iterations of the host's counter) as a queue stage while
    paths are unissued and the tail from the chain boundary e0 at which
    every path is issued (stream_tail): gated chains of the kernels and the
    tail's drains when `kernel`, else stages.loop_chains of the plain
    versions.  On the card without a sort the tail drain is enqueued
    behind each batch of the queue stage (stages.BodyKernel.queued).
    Returns (pool, evaluations)."""
    kw = dict(sort_every=sort_every, defer=defer, check_every=check_every)
    if kernel:
        s, issued = own(s), issued.clone()
        e0, n = KERNEL.stream(ctx, s, issued, accum, sort_every=sort_every,
                              defer=defer, k_chain=check_every,
                              reorder=_reorder(ctx))
        KERNEL.last_split = {"e0": e0, "E": n}
    else:
        s, issued, e0 = stream_queue(ctx, s, issued, accum, kernel=False,
                                     **kw)
        s, n = stream_tail(ctx, s, issued, accum, e0, kernel=False, **kw)
    KERNEL.evals += n
    return s, n


def stream_queue(ctx: FamilyContext, s, issued, accum, *, sort_every: int,
                 defer: bool, check_every: int, kernel: bool):
    """streaming.render_tile's loop from iteration 0 while paths are
    unissued, in chains of check_every iterations: gated chains of the
    kernels when `kernel` (on copies of the pool and paths_issued), else
    stages.loop_chains of the plain versions.  Returns (pool,
    paths_issued, e0): e0 the first chain boundary with every path
    issued."""
    if kernel:
        s, issued = own(s), issued.clone()
        e0 = KERNEL.stream_queue(ctx, s, issued, accum, sort_every=sort_every,
                                 defer=defer, k_chain=check_every,
                                 reorder=_reorder(ctx))
        return s, issued, e0
    (s, issued), e0 = stages.loop_chains(
        KERNEL, (s, issued), lambda c: _queue_count(ctx, c[1]),
        _stream_body(ctx, accum, 0, sort_every=sort_every, defer=defer), 0,
        check_every)
    return s, issued, e0


def stream_tail(ctx: FamilyContext, s, issued, accum, e0: int, *,
                sort_every: int, defer: bool, check_every: int,
                kernel: bool):
    """streaming.render_tile's loop from iteration e0 (a multiple of
    check_every), at which every path is issued: the tail's drains when
    `kernel` (s's tensors, which must be its own, updated in place; the
    extend drain, or with a sort gated chains of the sort, the flush and
    drain segments), else the eager loop's chains while a lane is alive.
    Returns (pool, the loop's trip count)."""
    if kernel:
        _, n = KERNEL.stream(ctx, s, issued, accum, sort_every=sort_every,
                             defer=defer, k_chain=check_every,
                             reorder=_reorder(ctx), e0=e0)
        KERNEL.last_split = {"e0": e0, "E": n}
        return s, n
    (s, _), n = stages.loop_chains(
        KERNEL, (s, issued), lambda c: _alive_count(c[0]),
        _stream_body(ctx, accum, e0, sort_every=sort_every, defer=defer),
        0, check_every)
    KERNEL.last_split = {"e0": e0, "E": e0 + n}
    return s, e0 + n


def _reorder(ctx: FamilyContext):
    """The Morton sort of a pool in place on the card (its tensors stay the
    kernels'): reorder(pool, ctrl, k_chain) prepares the sort, gated on the
    loop's control words, once, and returns the function that launches it
    (ops/lanesort.py)."""
    from . import lanesort  # noqa: PLC0415

    def reorder(p, ctrl, k_chain):
        prep = lanesort.KERNEL.prepare_morton(ctx, p, ctrl, k_chain)
        dev = p.alive.device
        return lambda: lanesort.KERNEL.launch(prep, dev)

    return reorder


def _stream_body(ctx: FamilyContext, accum, it: int, *, sort_every: int,
                 defer: bool):
    """The eager loop's iteration on (pool, paths_issued) from the host's
    iteration counter `it`: the Morton sort (and with `defer` the flush)
    every sort_every iterations, a refill, an extend."""
    from ..models import streaming  # noqa: PLC0415

    med = ctx.scene.medium

    def body(c):
        nonlocal it
        p, iss = c
        if sort_every > 0 and it % sort_every == 0:
            p = streaming._morton_reorder(p, med.box_min, med.box_max)
            if defer:
                p, _ = plain_body(ctx, "flush", p, accum=accum)
        p, _, iss = plain_body(ctx, "refill", p, issued=iss)
        p, _ = plain_body(ctx, "extend", p, accum=accum, defer=defer)
        it += 1
        return (p, iss), None

    return body


# -- the bound -----------------------------------------------------------------

#: bytes of each per-lane field (the RNG's two words split)
FIELD_BYTES = dict(o=12, d=12, throughput=12, radiance=12, alive=1,
                   rng_state=8, rng_inc=8, image_id=8, tracking=1, t=4,
                   max_t=4, normal=12, pending=1, p_scat=12)


class Traffic(stages.Traffic):
    """family_bytes over evaluations given in order, added one at a time (a
    drain's taps need not be kept)."""

    def __init__(self, ctx: FamilyContext):
        nch = int(ctx.scene.medium.albedo.data.shape[-1])
        super().__init__(FIELD_BYTES, {"density": 4, "albedo": 4 * nch,
                                       "accum": 24})


def family_bytes(ctx: FamilyContext, taps) -> int:
    """The least bytes the evaluations whose `taps` are given move (the
    lists the eager functions fill: ("state", stages.lane_traffic), and
    ("density", flat voxels), ("albedo", flat albedo voxels) and ("accum",
    pixels) of the lanes that read or add them).  Each lane reads the fields
    its evaluation reads (a dead lane its alive flag alone) and writes the
    fields it changes; the distinct voxels are read once (4 B, the albedo
    its channels), and each pixel a splat adds to is read and written once
    (24 B).  Given every evaluation of a drain, in order, the drain's."""
    return Traffic(ctx).add(taps).total()
