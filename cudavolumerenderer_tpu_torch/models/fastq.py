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

Port note: the lax.while_loop is a host loop that reads its condition
once every `check_every` iterations (an iteration after the last splat
changes nothing); the refill and the periodic flush run on the host's
iteration counter, which is the JAX loop's; the drain flush, which JAX
decides on the device, is a flush masked by that device flag, so the
host never waits for it.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..constants import EPSILON
from ..ops import aabb, camera as cam, phase
from ..ops.rng import make_rng, next_float, next_uint32
from ..scene.types import RenderSettings, Scene
from . import integrator
from .fast import (
    BRICK,
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
):
    """Render a tile; returns (img (th, tw, 3), n_rays), and with
    with_stats also the JAX loop's trip count and the sum over
    iterations of tracking lanes (n_iters, n_busy, both f32 tensors)."""
    dev = scene.device
    tile_offset = torch.as_tensor(tile_offset, dtype=torch.float32, device=dev)
    tw, th = tile_dim
    n_pix = tw * th
    n_paths = n_pix * spp
    n_lanes = min(n_lanes, n_paths)
    med = scene.medium

    fused = make_fused_grid(scene)
    nz, ny, nx = med.density.data.shape
    res_minus_1 = torch.tensor(
        [nx - 1, ny - 1, nz - 1], dtype=torch.float32, device=dev
    )
    extent = med.box_max - med.box_min
    scale = med.scale
    inv_sigmat = 1.0 / (scale * med.max_density)
    if two_level:
        bz_, by_, bx_ = BRICK
        nby, nbx = -(-ny // by_), -(-nx // bx_)
        bm_flat = brick_majorants(med.density.data).reshape(-1)
        brick_size = torch.tensor(
            [bx_, by_, bz_], dtype=torch.float32, device=dev
        )
        brick_hi = torch.tensor(
            [nbx - 1, nby - 1, -(-nz // bz_) - 1], device=dev
        )
        epsw = torch.amax(extent) * 1e-6

    def zeros(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=dev)

    o, rad, pend_rad, normal = (zeros(n_lanes, 3) for _ in range(4))
    d = torch.tensor([0.0, 0.0, 1.0], device=dev).repeat(n_lanes, 1)
    tput = torch.ones((n_lanes, 3), dtype=torch.float32, device=dev)
    image_id = zeros(n_lanes, dtype=torch.int64)
    pend_pix = torch.full((n_lanes,), -1, dtype=torch.int64, device=dev)
    alive = zeros(n_lanes, dtype=torch.bool)
    tracking = zeros(n_lanes, dtype=torch.bool)
    t, max_t, inv_sig_local = zeros(n_lanes), zeros(n_lanes), zeros(n_lanes)
    brick_exit = torch.full((n_lanes,), -1.0, device=dev)
    rng = make_rng(seed, zeros(n_lanes, dtype=torch.int64))
    paths_issued = zeros(dtype=torch.int64)
    accum = zeros(n_pix, 3)
    n_rays, n_iters, n_busy = zeros(), zeros(), zeros()

    def more():
        return torch.any(torch.logical_or(alive, pend_pix >= 0)) | (
            paths_issued < n_paths
        )

    it = 0
    while bool(more()):
        for _ in range(check_every):
            if with_stats:
                n_iters = n_iters + more()

            # ---- flush pending splats every FLUSH_EVERY iterations, and
            # on every iteration once the queue is empty (the drain) ------
            if it % FLUSH_EVERY == FLUSH_EVERY - 1:
                pend_rad, pend_pix = _flush(accum, pend_rad, pend_pix)
            else:
                pend_rad, pend_pix = _flush(
                    accum, pend_rad, pend_pix, when=paths_issued >= n_paths
                )

            # ---- regenerate from the deterministic queue, batched every
            # REFILL_EVERY iterations --------------------------------------
            if it % REFILL_EVERY == 0:
                refillable = torch.logical_and(
                    torch.logical_not(alive), pend_pix < 0
                )
                takes, image_id_new, o_new, d_new, rng, paths_issued = (
                    queue_refill(refillable, rng, paths_issued, n_paths,
                                 tile_dim, tile_offset, full_resolution,
                                 camera, seed, path_id_base)
                )
                mm = takes[..., None]
                o = torch.where(mm, o_new, o)
                d = torch.where(mm, d_new, d)
                tput = torch.where(mm, 1.0, tput)
                rad = torch.where(mm, 0.0, rad)
                image_id = torch.where(takes, image_id_new, image_id)
                alive = torch.logical_or(alive, takes)
                tracking = torch.where(takes, False, tracking)
            alive_after_regen = alive

            # ---- segment start --------------------------------------------
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

            # ---- one tracking step (fastSK's physics) ---------------------
            step_mask = tracking
            if two_level:
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
                    brick_hi,
                )
                bflat = (bi[..., 2] * nby + bi[..., 1]) * nbx + bi[..., 0]
                rho_b = bm_flat[bflat]
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
                step = -torch.log(torch.clamp(u1, min=EPSILON)) * inv_sigmat
                t_new = torch.where(step_mask, t + step, t)
                overran = torch.logical_and(step_mask, t_new > max_t)
                inside = torch.logical_and(step_mask, torch.logical_not(overran))
                inv_sig = inv_sigmat

            p = o + t_new[..., None] * d
            coord = (
                torch.clamp((p - med.box_min) / extent, 0.0, 1.0) * res_minus_1
            )
            tap_bits, rng = next_uint32(rng, inside)
            tap = _stochastic_tap(coord, tap_bits)
            ix = torch.clamp(tap[..., 0], 0, nx - 1)
            iy = torch.clamp(tap[..., 1], 0, ny - 1)
            iz = torch.clamp(tap[..., 2], 0, nz - 1)
            rho_hat, alb_hat = fused_row_decode(
                scene, fused[(iz * ny + iy) * nx + ix]
            )
            u2, rng = next_float(rng, inside)
            scattered = torch.logical_and(
                inside, torch.logical_not(scale * rho_hat * inv_sig < u2)
            )
            t = t_new
            tracking = torch.logical_and(
                tracking, torch.logical_not(torch.logical_or(overran, scattered))
            )

            # ---- boundary event ---------------------------------------
            boundary = torch.logical_or(boundary_now, overran)
            o_bound = torch.where(
                boundary_now[..., None],
                o + d * isect.dist[..., None],
                o + d * max_t[..., None],
            )
            o_b, d_b, t_b, rng = integrator.boundary_event(
                scene, settings, normal, o_bound, d, tput, rng, boundary
            )

            # ---- scatter event ----------------------------------------
            o_s = o + d * t[..., None] - d * EPSILON
            d_s, rng = phase.sample_phase(d, med.g, rng, active=scattered)
            sc, bd = scattered[..., None], boundary[..., None]
            o = torch.where(sc, o_s, torch.where(bd, o_b, o))
            d = torch.where(sc, d_s, torch.where(bd, d_b, d))
            tput = torch.where(sc, tput * alb_hat, torch.where(bd, t_b, tput))

            # ---- Russian roulette -------------------------------------
            had_event = torch.logical_and(
                alive, torch.logical_or(scattered, boundary)
            )
            if settings.russian_roulette:
                tput, alive, _, rng = integrator.russian_roulette(
                    tput, alive, rng, had_event
                )

            # ---- finished paths park in the pending slot; the lane is
            # refillable once its image_id is -1 --------------------------
            died = torch.logical_and(alive_after_regen, torch.logical_not(alive))
            can_park = torch.logical_and(died, pend_pix < 0)
            cp = can_park[..., None]
            pend_rad = torch.where(cp, rad, pend_rad)
            pend_pix = torch.where(can_park, image_id, pend_pix)
            rad = torch.where(cp, 0.0, rad)
            image_id = torch.where(can_park, -1, image_id)

            if with_stats:
                n_busy = n_busy + torch.sum(tracking.to(torch.float32))
            it += 1

    # final drain of any remaining pending slots
    _flush(accum, pend_rad, pend_pix)
    img = accum.reshape(th, tw, 3)
    if with_stats:
        return img, n_rays, n_iters, n_busy
    return img, n_rays
