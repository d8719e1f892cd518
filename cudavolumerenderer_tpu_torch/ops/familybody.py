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
          refill (regenerationSK), or drained (naiveSK's trace: each lane
          bounces until it dies, in one launch);
  refill  regeneration.queue_refill with `_regenerate`'s group rule, and
          streaming._refill's field resets;
  extend  streaming.extend_step (with `defer` sortingSK's stall), and
          flush, streaming.flush_pending.

This module holds the gate (`route`), the parameter vectors
(`make_context`), the plain versions (`plain_body`, the eager functions),
the wrapper `run_body` (the plain version for CPU tensors, the kernel for
CUDA tensors, or it raises), the schedulers' loops (`regenerate_loop`,
`stream_loop`: stages.loop_chains of the plain bodies, or gated chains of
the kernels; `trace`, the drain) and the bound (`family_bytes`).  The
kernels update a pool's per-lane tensors in place unless given `out`.
"""

from __future__ import annotations

import ctypes
import dataclasses
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ..constants import EPSILON
from . import stages
from .rng import as_u32, jump_constants, mul32
from .stages import C_COUNT, DRAIN_CAP, N_CTRL, lane_field, own
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
 IP_CHAIN, IP_CAP, IP_VARIABLE, IP_LOOK, IP_LANES, N_IP) = range(29)

#: the entry points (IP_OP)
OPS = ("bounce", "refill", "extend", "flush")

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
    the drain's, `plain_evals` each entry point's evaluations by its plain
    version, `evals` the schedulers' loop evaluations (a bounce or an
    extend of the pool: the host's wavefront passes), kernel or plain."""

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

    def prepare(self, ctx: FamilyContext, op: str, s, *, out=None,
                image_id=None, accum=None, issued=None, issued_out=None,
                n_rays_out=None, count=None, ctrl=None, hist=None,
                defer: bool = False, chain: int = 1, cap: int = 0) -> Prepared:
        """The checked arguments of launches of `op` on the pool `s` (a
        PathState, with `image_id` for a refill or a splat, or a
        StreamState) that write `out`'s per-lane fields (s's when None),
        n_rays to `n_rays_out`, the count to `count` (0-d int64), and
        paths_issued from `issued` to `issued_out`; gated on `ctrl` when
        given (chain `chain`, threshold 0); `hist` the drain's histogram."""
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
        iparams[IP_LOOK], iparams[IP_LANES] = lookahead(width)
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

    def regenerate_gated(self, ctx: FamilyContext, s, image_id, issued,
                         accum) -> int:
        """regeneration.render_tile's loop in gated chains of a refill and a
        bounce with the splat: the pool, image_id, paths_issued and n_rays
        updated in place; returns the evaluations."""
        dev = s.alive.device
        ctrl = torch.zeros(N_CTRL, dtype=torch.int64, device=dev)
        ctrl[C_COUNT] = torch.count_nonzero(s.alive) + (ctx.n_paths - issued)
        refill = self.prepare(ctx, "refill", s, image_id=image_id,
                              issued=issued, ctrl=ctrl)
        bounce = self.prepare(ctx, "bounce", s, image_id=image_id,
                              accum=accum, issued=issued,
                              count=ctrl[C_COUNT], ctrl=ctrl)

        def chain():
            self.launch(refill, dev)
            self.launch(bounce, dev)

        return self.gated(chain, ctrl, 0, 1, dev)

    def stream_gated(self, ctx: FamilyContext, s, issued, accum, *,
                     sort_every: int, defer: bool, k_chain: int,
                     reorder) -> int:
        """streaming.render_tile's loop in gated chains of k_chain
        evaluations, each a refill and an extend (after `reorder(s)`, the
        Morton sort in place, and with `defer` a flush, on the host's
        iteration counter every sort_every iterations): the pool,
        paths_issued and n_rays updated in place; returns the evaluations."""
        dev = s.alive.device
        ctrl = torch.zeros(N_CTRL, dtype=torch.int64, device=dev)
        ctrl[C_COUNT] = torch.count_nonzero(s.alive) + (ctx.n_paths - issued)
        flush = self.prepare(ctx, "flush", s, accum=accum, ctrl=ctrl,
                             chain=k_chain)
        refill = self.prepare(ctx, "refill", s, issued=issued, ctrl=ctrl,
                              chain=k_chain)
        extend = self.prepare(ctx, "extend", s, accum=accum, issued=issued,
                              count=ctrl[C_COUNT], ctrl=ctrl, defer=defer,
                              chain=k_chain)
        it = 0

        def chain():
            nonlocal it
            for _ in range(k_chain):
                if sort_every > 0 and it % sort_every == 0:
                    reorder(s)
                    if defer:
                        self.launch(flush, dev)
                self.launch(refill, dev)
                self.launch(extend, dev)
                it += 1

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


def _queue_count(ctx: FamilyContext, s, issued) -> int:
    """The loop condition's count: lanes alive plus paths not yet issued
    (one host read)."""
    return int(torch.count_nonzero(s.alive) + (ctx.n_paths - issued))


def regenerate_loop(ctx: FamilyContext, s, image_id, issued, accum,
                    kernel: bool):
    """regeneration.render_tile's loop (refill, then a bounce that splats
    the lanes it ends, while a lane is alive or a path unissued): gated
    chains of the kernels when `kernel`, else stages.loop_chains of the
    plain versions.  Returns (pool, evaluations)."""
    if kernel:
        s, image_id, issued = own(s), image_id.clone(), issued.clone()
        n = KERNEL.regenerate_gated(ctx, s, image_id, issued, accum)
        KERNEL.evals += n
        return s, n

    def body(c):
        p, img, iss = plain_body(ctx, "refill", c[0], image_id=c[1],
                                 issued=c[2])
        p, _ = plain_body(ctx, "bounce", p, image_id=img, accum=accum)
        return (p, img, iss), None

    (s, _, _), n = stages.loop_chains(
        KERNEL, (s, image_id, issued),
        lambda c: _queue_count(ctx, c[0], c[2]), body, 0, 1)
    KERNEL.evals += n
    return s, n


def stream_loop(ctx: FamilyContext, s, issued, accum, *, sort_every: int,
                defer: bool, check_every: int, kernel: bool):
    """streaming.render_tile's loop (chains of check_every iterations while
    a lane is alive or a path unissued; each iteration a refill and an
    extend, after the Morton sort and with `defer` the flush every
    sort_every iterations of the host's counter): gated chains of the
    kernels when `kernel`, else stages.loop_chains of the plain versions.
    Returns (pool, evaluations)."""
    from ..models import streaming  # noqa: PLC0415

    med = ctx.scene.medium
    if kernel:
        s, issued = own(s), issued.clone()

        def reorder(p):
            copy_lanes_(p, streaming._morton_reorder(p, med.box_min,
                                                     med.box_max))

        n = KERNEL.stream_gated(
            ctx, s, issued, accum, sort_every=sort_every, defer=defer,
            k_chain=check_every, reorder=reorder)
        KERNEL.evals += n
        return s, n
    it = 0

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

    (s, _), n = stages.loop_chains(
        KERNEL, (s, issued), lambda c: _queue_count(ctx, c[0], c[1]), body,
        0, check_every)
    KERNEL.evals += n
    return s, n


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
