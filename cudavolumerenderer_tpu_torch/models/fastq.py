"""fastQ: queue-fed fast wavefront with deferred splat flush.

Port of cudavolumerenderer_tpu/models/fastq.py.  fastSK's tracking
physics (fused density+albedo table, stochastic trilinear tap, optional
two-level sparse leap) with regenerationSK's queue load balancing
(RegenerationVolPTsk_kernel.cuh) and no per-iteration image scatter:

  * lanes pull path ids from the deterministic prefix-sum queue every
    REFILL_EVERY iterations (any lane may run any path);
  * a finished path's (pixel, radiance) moves to the lane's pending slot
    and the lane is free for the next path;
  * pending slots are flushed to the image with one masked scatter-add
    every FLUSH_EVERY iterations, and on every iteration once the queue
    is empty.

Port note: one iteration of the lax.while_loop's body is `plain_body` (the
eager torch ops, the plain version); ops/fastqbody.run runs the loop: on
the card the kernels of csrc/fastqbody.cu (gated chains while the queue
holds paths, then one drain launch), elsewhere or with eager_body=True
chains of plain iterations with a host read of the loop's count between
chains (an iteration after the loop's end changes nothing).  The refill
and the periodic flush run on the iteration index, which is the JAX
loop's; the drain flush, which JAX decides on the device, is a flush
masked by that device flag.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..constants import EPSILON
from ..ops import aabb, camera as cam, fastqbody, phase, stages
from ..ops.rng import RngState, make_rng, next_float, next_uint32
from ..scene.types import RenderSettings, Scene
from . import integrator
from .fast import (
    BRICK,
    _albedo_mode,
    _stochastic_tap,
    brick_majorants,
    fused_row_decode,
    make_fused_grid,
)
from .regeneration import queue_refill

FLUSH_EVERY = 8
REFILL_EVERY = 4
#: iterations per host read of the loop condition
CHECK_EVERY = 8


class QState(NamedTuple):
    """The loop's carry: the lane pool (SoA) and the queue and counters."""

    o: torch.Tensor  # (N, 3)
    d: torch.Tensor  # (N, 3)
    throughput: torch.Tensor  # (N, 3)
    radiance: torch.Tensor  # (N, 3) the path in flight's
    pend_rad: torch.Tensor  # (N, 3) a finished path's, parked
    normal: torch.Tensor  # (N, 3)
    t: torch.Tensor  # (N,)
    max_t: torch.Tensor  # (N,)
    inv_sig_local: torch.Tensor  # (N,) 1/(scale*rho_max_brick)
    brick_exit: torch.Tensor  # (N,) t at which the ray leaves its brick
    image_id: torch.Tensor  # (N,) int64 the path's pixel, -1 once parked
    pend_pix: torch.Tensor  # (N,) int64 the parked pixel, -1 when free
    alive: torch.Tensor  # (N,) bool a path in flight
    tracking: torch.Tensor  # (N,) bool
    rng: RngState
    paths_issued: torch.Tensor  # () int64
    n_rays: torch.Tensor  # () f32 segment starts
    n_iters: torch.Tensor  # () f32 the loop's trip count
    n_busy: torch.Tensor  # () f32 sum over iterations of tracking lanes


def initial_state(n_lanes: int, seed, dev) -> QState:
    """An empty pool: every lane dead with a free slot (the first iteration
    refills it)."""
    def zeros(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=dev)

    return QState(
        o=zeros(n_lanes, 3),
        d=torch.tensor([0.0, 0.0, 1.0], device=dev).repeat(n_lanes, 1),
        throughput=torch.ones((n_lanes, 3), dtype=torch.float32, device=dev),
        radiance=zeros(n_lanes, 3), pend_rad=zeros(n_lanes, 3),
        normal=zeros(n_lanes, 3), t=zeros(n_lanes), max_t=zeros(n_lanes),
        inv_sig_local=zeros(n_lanes),
        brick_exit=torch.full((n_lanes,), -1.0, device=dev),
        image_id=zeros(n_lanes, dtype=torch.int64),
        pend_pix=torch.full((n_lanes,), -1, dtype=torch.int64, device=dev),
        alive=zeros(n_lanes, dtype=torch.bool),
        tracking=zeros(n_lanes, dtype=torch.bool),
        rng=make_rng(seed, zeros(n_lanes, dtype=torch.int64)),
        paths_issued=zeros(dtype=torch.int64),
        n_rays=zeros(), n_iters=zeros(), n_busy=zeros(),
    )


def make_context(scene: Scene, camera: cam.Camera, settings: RenderSettings,
                 tile_dim, tile_offset, full_resolution, n_paths: int, seed,
                 path_id_base, two_level: bool) -> fastqbody.FastQContext:
    """The tensors the body reads besides the state, computed as the JAX
    body computes them: the fused table, the box and grid extents, the
    global majorant's reciprocal and, two-level, the brick majorants and
    geometry."""
    dev = scene.device
    med = scene.medium
    nz, ny, nx = med.density.data.shape
    extent = med.box_max - med.box_min
    kw = {}
    if two_level:
        bz_, by_, bx_ = BRICK
        nby, nbx = -(-ny // by_), -(-nx // bx_)
        kw = dict(
            bm_flat=brick_majorants(med.density.data).reshape(-1),
            brick_size=torch.tensor([bx_, by_, bz_], dtype=torch.float32,
                                    device=dev),
            brick_hi=torch.tensor([nbx - 1, nby - 1, -(-nz // bz_) - 1],
                                  device=dev),
            nbx=nbx, nby=nby, epsw=torch.amax(extent) * 1e-6)
    return fastqbody.FastQContext(
        scene, settings, camera, tuple(tile_dim), tile_offset,
        tuple(full_resolution), int(n_paths), seed, path_id_base,
        bool(two_level), albedo=_albedo_mode(scene),
        fused=make_fused_grid(scene),
        res_minus_1=torch.tensor([nx - 1, ny - 1, nz - 1],
                                 dtype=torch.float32, device=dev),
        extent=extent, inv_sigmat=1.0 / (med.scale * med.max_density), **kw)


def _flush(accum, pend_rad, pend_pix, when=None):
    """Splat the occupied pending slots into `accum` (in place) and free
    them; with `when` (a 0-d bool tensor) only if it holds."""
    full = pend_pix >= 0
    if when is not None:
        full = torch.logical_and(full, when)
    accum.index_add_(
        0, torch.clamp(pend_pix, min=0),
        torch.where(full[..., None], pend_rad, 0.0),
    )
    if when is None:
        return torch.zeros_like(pend_rad), torch.full_like(pend_pix, -1)
    return torch.where(when, 0.0, pend_rad), torch.where(when, -1, pend_pix)


def more(ctx: fastqbody.FastQContext, s: QState) -> torch.Tensor:
    """The loop's condition (a 0-d bool tensor): a path in flight or a
    pending result, or a path not yet issued."""
    return torch.any(torch.logical_or(s.alive, s.pend_pix >= 0)) | (
        s.paths_issued < ctx.n_paths
    )


def plain_body(ctx: fastqbody.FastQContext, s: QState, accum, it: int,
               taps=None) -> QState:
    """One iteration `it` of JAX's body (fastq.py:148) as eager torch ops:
    the flush, the refill every REFILL_EVERY iterations, the segment start,
    one tracking step, the boundary or scatter event, Russian roulette and
    the parking of finished paths; n_iters and n_busy count as with_stats
    counts them.  The flush adds into `accum` in place.  A list given as
    `taps` receives the iteration's traffic (fastqbody.fastq_bytes)."""
    scene, settings = ctx.scene, ctx.settings
    med = scene.medium
    n_paths = ctx.n_paths
    (o, d, tput, rad, pend_rad, normal, t, max_t, inv_sig_local, brick_exit,
     image_id, pend_pix, alive, tracking, rng, paths_issued, n_rays,
     n_iters, n_busy) = s
    n_iters = n_iters + more(ctx, s)
    extent, res_minus_1, scale = ctx.extent, ctx.res_minus_1, med.scale
    nz, ny, nx = med.density.data.shape

    # ---- flush pending splats every FLUSH_EVERY iterations, and on every
    # iteration once the queue is empty (the drain) ------------------------
    when = (None if it % FLUSH_EVERY == FLUSH_EVERY - 1
            else paths_issued >= n_paths)
    if taps is not None:
        flushed = pend_pix >= 0
        if when is not None:
            flushed = torch.logical_and(flushed, when)
        taps.append(("accum", pend_pix[flushed]))
    pend_rad, pend_pix = _flush(accum, pend_rad, pend_pix, when=when)

    # ---- regenerate from the deterministic queue, batched every
    # REFILL_EVERY iterations ----------------------------------------------
    takes = torch.zeros_like(alive)
    if it % REFILL_EVERY == 0:
        refillable = torch.logical_and(torch.logical_not(alive), pend_pix < 0)
        takes, image_id_new, o_new, d_new, rng, paths_issued = queue_refill(
            refillable, rng, paths_issued, n_paths, ctx.tile_dim,
            ctx.tile_offset, ctx.full_resolution, ctx.camera, ctx.seed,
            ctx.path_id_base)
        mm = takes[..., None]
        o = torch.where(mm, o_new, o)
        d = torch.where(mm, d_new, d)
        tput = torch.where(mm, 1.0, tput)
        rad = torch.where(mm, 0.0, rad)
        image_id = torch.where(takes, image_id_new, image_id)
        alive = torch.logical_or(alive, takes)
        tracking = torch.where(takes, False, tracking)
    alive_after_regen = alive

    # ---- segment start ----------------------------------------------------
    need_isect = torch.logical_and(alive, torch.logical_not(tracking))
    n_rays = n_rays + torch.sum(need_isect.to(torch.float32))
    isect = aabb.aabb_intersect(med.box_min, med.box_max, o, d)
    miss = torch.logical_and(need_isect, torch.logical_not(isect.hit))
    rad = torch.where(miss[..., None], rad + tput * scene.le, rad)
    alive = torch.logical_and(alive, torch.logical_not(miss))
    hit = torch.logical_and(need_isect, isect.hit)
    enters = torch.logical_and(hit, isect.inside_volume)
    boundary_now = torch.logical_and(
        hit, torch.logical_not(isect.inside_volume)
    )
    tracking = torch.logical_or(tracking, enters)
    t = torch.where(enters, 0.0, t)
    max_t = torch.where(enters, isect.dist, max_t)
    normal = torch.where(need_isect[..., None], isect.normal, normal)
    brick_exit = torch.where(enters, -1.0, brick_exit)

    # ---- one tracking step (fastSK's physics) -----------------------------
    step_mask = tracking
    if ctx.two_level:
        epsw, brick_size = ctx.epsw, ctx.brick_size
        need_brick = torch.logical_and(step_mask, t >= brick_exit)
        p_now = o + (t + epsw)[..., None] * d
        coordn = (
            torch.clamp((p_now - med.box_min) / extent, 0.0, 1.0)
            * res_minus_1
        )
        bi = torch.minimum(
            torch.clamp(
                torch.floor(coordn / brick_size).to(torch.int64), min=0
            ),
            ctx.brick_hi,
        )
        bflat = (bi[..., 2] * ctx.nby + bi[..., 1]) * ctx.nbx + bi[..., 0]
        rho_b = ctx.bm_flat[bflat]
        up = (d > 0.0).to(torch.float32)
        bound_coord = (bi.to(torch.float32) + up) * brick_size
        bound_world = med.box_min + extent * bound_coord / res_minus_1
        okd = torch.abs(d) > 1e-12
        t_axes = torch.where(
            okd, (bound_world - o) / torch.where(okd, d, 1.0), torch.inf
        )
        exit_new = torch.maximum(torch.amin(t_axes, dim=-1), t + epsw)
        brick_exit = torch.where(need_brick, exit_new, brick_exit)
        inv_new = torch.where(
            rho_b > 0.0,
            1.0 / (scale * torch.clamp(rho_b, min=1e-30)),
            torch.inf,
        )
        inv_sig_local = torch.where(need_brick, inv_new, inv_sig_local)
        empty = torch.logical_and(
            step_mask, torch.logical_not(torch.isfinite(inv_sig_local))
        )
        stepping = torch.logical_and(step_mask, torch.logical_not(empty))
        u1, rng = next_float(rng, stepping)
        step = torch.where(
            stepping,
            -torch.log(torch.clamp(u1, min=EPSILON)) * inv_sig_local,
            0.0,
        )
        t_cand = torch.where(empty, brick_exit, t + step)
        eff_exit = torch.minimum(brick_exit, max_t)
        crossed = torch.logical_and(step_mask, t_cand >= eff_exit)
        overran = torch.logical_and(crossed, max_t <= brick_exit)
        transit = torch.logical_and(crossed, torch.logical_not(overran))
        inside = torch.logical_and(stepping, torch.logical_not(crossed))
        t_new = torch.where(
            transit, brick_exit, torch.where(step_mask, t_cand, t)
        )
        inv_sig = inv_sig_local
    else:
        u1, rng = next_float(rng, step_mask)
        step = -torch.log(torch.clamp(u1, min=EPSILON)) * ctx.inv_sigmat
        t_new = torch.where(step_mask, t + step, t)
        overran = torch.logical_and(step_mask, t_new > max_t)
        inside = torch.logical_and(step_mask, torch.logical_not(overran))
        inv_sig = ctx.inv_sigmat

    p = o + t_new[..., None] * d
    coord = torch.clamp((p - med.box_min) / extent, 0.0, 1.0) * res_minus_1
    tap_bits, rng = next_uint32(rng, inside)
    tap = _stochastic_tap(coord, tap_bits)
    ix = torch.clamp(tap[..., 0], 0, nx - 1)
    iy = torch.clamp(tap[..., 1], 0, ny - 1)
    iz = torch.clamp(tap[..., 2], 0, nz - 1)
    flat = (iz * ny + iy) * nx + ix
    rho_hat, alb_hat = fused_row_decode(scene, ctx.fused[flat])
    u2, rng = next_float(rng, inside)
    scattered = torch.logical_and(
        inside, torch.logical_not(scale * rho_hat * inv_sig < u2)
    )
    t = t_new
    tracking = torch.logical_and(
        tracking, torch.logical_not(torch.logical_or(overran, scattered))
    )

    # ---- boundary event -------------------------------------------------
    boundary = torch.logical_or(boundary_now, overran)
    o_bound = torch.where(
        boundary_now[..., None],
        o + d * isect.dist[..., None],
        o + d * max_t[..., None],
    )
    o_b, d_b, t_b, rng = integrator.boundary_event(
        scene, settings, normal, o_bound, d, tput, rng, boundary
    )

    # ---- scatter event --------------------------------------------------
    o_s = o + d * t[..., None] - d * EPSILON
    d_s, rng = phase.sample_phase(d, med.g, rng, active=scattered)
    sc, bd = scattered[..., None], boundary[..., None]
    o = torch.where(sc, o_s, torch.where(bd, o_b, o))
    d = torch.where(sc, d_s, torch.where(bd, d_b, d))
    tput = torch.where(sc, tput * alb_hat, torch.where(bd, t_b, tput))

    # ---- Russian roulette -----------------------------------------------
    had_event = torch.logical_and(
        alive, torch.logical_or(scattered, boundary)
    )
    if settings.russian_roulette:
        tput, alive, _, rng = integrator.russian_roulette(
            tput, alive, rng, had_event
        )

    # ---- finished paths park in the pending slot; the lane is
    # refillable once its image_id is -1 ----------------------------------
    died = torch.logical_and(alive_after_regen, torch.logical_not(alive))
    can_park = torch.logical_and(died, pend_pix < 0)
    cp = can_park[..., None]
    pend_rad = torch.where(cp, rad, pend_rad)
    pend_pix = torch.where(can_park, image_id, pend_pix)
    rad = torch.where(cp, 0.0, rad)
    image_id = torch.where(can_park, -1, image_id)

    n_busy = n_busy + torch.sum(tracking.to(torch.float32))
    new = QState(o, d, tput, rad, pend_rad, normal, t, max_t, inv_sig_local,
                 brick_exit, image_id, pend_pix, alive, tracking, rng,
                 paths_issued, n_rays, n_iters, n_busy)
    if taps is not None:
        # the lanes whose iteration reads each field before it writes it
        kept = torch.logical_not(takes)
        ones = torch.ones_like(alive)
        none = torch.zeros_like(alive)
        ggx_on = settings.bsdf_kind == "ggx"
        rr = settings.russian_roulette
        stepped = torch.logical_and(step_mask, torch.logical_not(enters))
        drew = stages.changed(s.rng.state, new.rng.state) & kept
        reads = {
            "alive": ones, "pend_pix": ones, "pend_rad": flushed,
            "o": alive_after_regen & kept, "d": alive_after_regen & kept,
            "tracking": alive_after_regen & kept,
            "throughput": (miss | scattered | (boundary if ggx_on else none)
                           | (had_event if rr else none)) & kept,
            "radiance": (miss | can_park) & kept,
            "normal": (overran & ~need_isect) if ggx_on else none,
            "image_id": can_park & kept, "t": stepped, "max_t": stepped,
            "brick_exit": stepped if ctx.two_level else none,
            "inv_sig_local": (stepped & ~need_brick) if ctx.two_level
            else none,
            "rng_state": drew, "rng_inc": drew,
        }
        taps += [("tap", flat[inside]),
                 ("state", stages.lane_traffic(s, new, reads,
                                               fastqbody.LANE_FIELDS))]
        if ctx.two_level:
            taps.append(("brick", bflat[need_brick]))
    return new


def render_tile(
    scene: Scene,
    camera: cam.Camera,
    settings: RenderSettings,
    tile_dim: Tuple[int, int],
    tile_offset,
    full_resolution: Tuple[int, int],
    spp: int,
    seed,
    path_id_base,
    n_lanes: int = 1 << 16,
    two_level: bool = False,
    with_stats: bool = False,
    check_every: int = CHECK_EVERY,
    eager_body: bool = False,
):
    """Render a tile; returns (img (th, tw, 3), n_rays), and with
    with_stats also the JAX loop's trip count and the sum over
    iterations of tracking lanes (n_iters, n_busy, both f32 tensors).  On
    the card the loop runs through csrc/fastqbody.cu (ops/fastqbody.run)
    unless eager_body=True asks for the eager body."""
    dev = scene.device
    tile_offset = torch.as_tensor(tile_offset, dtype=torch.float32, device=dev)
    tw, th = tile_dim
    n_pix = tw * th
    n_paths = n_pix * spp
    n_lanes = min(n_lanes, n_paths)
    ctx = make_context(scene, camera, settings, tile_dim, tile_offset,
                       full_resolution, n_paths, seed, path_id_base,
                       two_level)
    accum = torch.zeros((n_pix, 3), dtype=torch.float32, device=dev)
    s = fastqbody.run(ctx, initial_state(n_lanes, seed, dev), accum,
                      fastqbody.route(dev.type, eager_body), check_every)
    # final drain of any remaining pending slots
    _flush(accum, s.pend_rad, s.pend_pix)
    img = accum.reshape(th, tw, 3)
    if with_stats:
        return img, s.n_rays, s.n_iters, s.n_busy
    return img, s.n_rays
