"""fastQ's body kernels (csrc/fastqbody.cu, ops/fastqbody.py) on the CPU,
which has no card.

fastQ now runs its loop through ops/fastqbody.run (the plain body on the
CPU, the kernels on the card: gated chains while the queue holds paths,
then one drain launch).  Here: the new runner (chains of the plain body
while paths are unissued, then while lanes are pending) against the
parent's host loop (transcribed below) bit for bit in image, n_rays,
n_iters and n_busy, at pools of 64 and 200 lanes (200 is no multiple of the
kernel's 256-lane refill block), one- and two-level, RR on and off, GGX and
null, and on a constant and a 'full' albedo table; each row against JAX's
fastq.render_tile at 16^2 x 4 with tests/test_torch_schedulers.py's
tolerances; a dead lane with no pending result facing an empty queue is a
fixed point of the body, and a lane run alone once the queue is empty (the
drain's premise) equals its run in the pool; the drain's float32 fold of
per-iteration counts, past 2^24; the parameter vectors against the values
the eager body reads, and the C layout against the wrapper; the routing and
a failed build; the byte bound.  The kernels against the eager body, bit
for bit, are in tests/test_torch_cuda.py (card tests).
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from cudavolumerenderer_tpu.models import fastq as jfastq
from cudavolumerenderer_tpu_torch.config import Config, Kernel
from cudavolumerenderer_tpu_torch.constants import EPSILON
from cudavolumerenderer_tpu_torch.models import fastq, integrator
from cudavolumerenderer_tpu_torch.models.fast import (
    BRICK,
    _stochastic_tap,
    brick_majorants,
    fused_row_decode,
    make_fused_grid,
)
from cudavolumerenderer_tpu_torch.models.fastq import (
    CHECK_EVERY,
    FLUSH_EVERY,
    REFILL_EVERY,
    _flush,
)
from cudavolumerenderer_tpu_torch.models.regeneration import queue_refill
from cudavolumerenderer_tpu_torch.models.renderer import make_kernel_fn
from cudavolumerenderer_tpu_torch.ops import aabb, fastqbody, phase, stages
from cudavolumerenderer_tpu_torch.ops.rng import make_rng, next_float, next_uint32
from cudavolumerenderer_tpu_torch.scene import procedural
from cudavolumerenderer_tpu_torch.scene import types as ttypes
from cudavolumerenderer_tpu_torch.utils import cuda_build
from test_torch_fastbody import enum_values
from test_torch_schedulers import JAX_TOL, args_pair

torch.set_num_threads(2)

SOURCE = Path(fastqbody.__file__).resolve().parents[1] / "csrc" / "fastqbody.cu"
RES, SPP = 12, 2


# -- the parent's host loop, transcribed -------------------------------------------

def parent_fastq(
    scene,
    camera,
    settings,
    tile_dim,
    tile_offset,
    full_resolution,
    spp: int,
    seed,
    path_id_base,
    n_lanes: int = 1 << 16,
    two_level: bool = False,
    with_stats: bool = False,
    check_every: int = CHECK_EVERY,
):
    """The parent's models/fastq.render_tile: its host loop around the
    eager body, as it was."""
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



def scene_of(albedo):
    """The blob 32^3 scene of args_pair with another albedo: a constant
    (0.8, 0.6, 0.9), or random per-voxel rows ('full')."""
    d = procedural.blob_volume()
    albedo = (np.random.RandomState(3).rand(*d.shape, 3).astype(np.float32)
              if albedo == "full" else (0.8, 0.6, 0.9))
    return ttypes.make_scene(ttypes.make_medium(
        d, albedo, scale=40.0, max_density=1.0, device="cpu"))


def case_args(res=RES, spp=SPP, rr=True, bsdf="ggx", albedo="affine"):
    """render_tile's arguments: args_pair's blob scene and camera (its
    albedo affine in density, or scene_of's) at res^2 x spp."""
    t_args, _ = args_pair(res=res, spp=spp)
    settings = ttypes.RenderSettings.from_flags(True, russian_roulette=rr,
                                                bsdf_kind=bsdf)
    scene = t_args[0] if albedo == "affine" else scene_of(albedo)
    return (scene, t_args[1], settings) + tuple(t_args[3:])


CASES = [(lanes, two, rr, bsdf, "affine") for lanes in (64, 200)
         for two in (False, True) for rr in (True, False)
         for bsdf in ("ggx", "null")] + [
    (200, True, True, "ggx", "const"), (200, False, True, "ggx", "full"),
    (64, True, False, "null", "full")]


def case_id(c):
    lanes, two, rr, bsdf, albedo = c
    return (f"{lanes}-{'two' if two else 'one'}-{'rr' if rr else 'no-rr'}-"
            f"{bsdf}-{albedo}")


@pytest.mark.parametrize("case", CASES, ids=[case_id(c) for c in CASES])
def test_runner_equals_parent_loop(case):
    """fastq.render_tile through ops/fastqbody.run on the CPU (chains of
    the plain body while paths are unissued, then while lanes are pending)
    gives the parent's image, n_rays, n_iters and n_busy bit for bit, and
    counts the loop's iterations as its trip count, with no launch."""
    lanes, two, rr, bsdf, albedo = case
    args = case_args(rr=rr, bsdf=bsdf, albedo=albedo)
    kw = dict(n_lanes=lanes, two_level=two, with_stats=True)
    want = parent_fastq(*args, **kw)
    fastqbody.KERNEL.reset()
    got = fastq.render_tile(*args, **kw)
    assert torch.equal(got[0], want[0])
    for a, b in zip(got[1:], want[1:]):
        assert a.dtype == b.dtype == torch.float32 and float(a) == float(b)
    assert fastqbody.KERNEL.evals == int(want[2]) > 0
    assert fastqbody.KERNEL.plain_evals >= fastqbody.KERNEL.evals
    assert fastqbody.KERNEL.launches == fastqbody.KERNEL.drain_launches == 0


@pytest.mark.parametrize("two_level", [False, True], ids=["one", "two"])
def test_row_matches_jax_render_tile(two_level):
    """16^2 x 4 on 200 lanes against JAX's fastq.render_tile: one-level
    n_rays exact and images to 1e-4; two-level within the brick-exit tie
    of tests/test_torch_schedulers.py (a few paths take the other branch:
    >= 97% of pixels to 1e-4, n_rays to 1e-3, means to 1%)."""
    t_args, j_args = args_pair(res=16, spp=4)
    kw = dict(n_lanes=200, two_level=two_level)
    a, ra = fastq.render_tile(*t_args, **kw)
    b, rb = jfastq.render_tile(*j_args, **kw)
    a, b, ra, rb = a.numpy(), np.asarray(b), float(ra), float(rb)
    assert np.isfinite(a).all() and ra > 16 * 16 * 4
    if not two_level:
        assert ra == rb
        np.testing.assert_allclose(a, b, **JAX_TOL)
        return
    same = np.all(np.isclose(a, b, **JAX_TOL), axis=-1)
    assert same.mean() >= 0.97 and abs(ra - rb) <= 1e-3 * rb
    assert abs(a.mean() - b.mean()) < 0.01 * b.mean()


# -- the drain's premises ----------------------------------------------------------------

def context_and_state(two_level, n_lanes=64, res=RES, spp=SPP, rr=True,
                      bsdf="ggx"):
    """A context of case_args's render and its initial state and image."""
    scene, camera, settings, tile_dim, tile_offset, full, spp, seed, base = (
        case_args(res=res, spp=spp, rr=rr, bsdf=bsdf))
    n_paths = tile_dim[0] * tile_dim[1] * spp
    ctx = fastq.make_context(scene, camera, settings, tile_dim, tile_offset,
                             full, n_paths, seed, base, two_level)
    accum = torch.zeros((tile_dim[0] * tile_dim[1], 3))
    return ctx, fastq.initial_state(n_lanes, seed, "cpu"), accum


def until_queue_empty(ctx, s, accum):
    """Plain iterations until every path is issued: (state, next it)."""
    it = 0
    while int(s.paths_issued) < ctx.n_paths:
        s = fastq.plain_body(ctx, s, accum, it)
        it += 1
    return s, it


def lanes(s, keep):
    return {n: stages.lane_field(s, n)[keep] for n in fastqbody.LANE_FIELDS}


def one_lane(s, i):
    """Lane i of a pool as a pool of its own, its counters zero."""
    def take(v):
        if isinstance(v, tuple):
            return type(v)(*(take(x) for x in v))
        return v[i:i + 1].clone() if v.ndim else torch.zeros_like(v)

    return fastq.QState(*(take(v) for v in s))._replace(
        paths_issued=s.paths_issued.clone())


@pytest.mark.parametrize("two_level", [False, True], ids=["one", "two"])
def test_dead_lane_facing_an_empty_queue_is_a_fixed_point(two_level):
    """Once every path is issued, a lane that is dead with a free slot
    keeps every field and draws nothing through a refill iteration, a
    periodic flush and an ordinary one; so the drain may stop it."""
    ctx, s, accum = context_and_state(two_level)
    s, it = until_queue_empty(ctx, s, accum)
    for _ in range(3):
        s = fastq.plain_body(ctx, s, accum, it)
        it += 1
    still = torch.logical_and(~s.alive, s.pend_pix < 0)
    assert still.any() and (~still).any()
    for k in range(8):  # covers it % 4 == 0 and it % 8 == 7
        after = fastq.plain_body(ctx, s, accum.clone(), it + k)
        for n, x in lanes(s, still).items():
            assert torch.equal(x, lanes(after, still)[n]), n


@pytest.mark.parametrize("two_level", [False, True], ids=["one", "two"])
def test_lane_alone_in_the_drain_equals_the_loop(two_level):
    """From the iteration at which the queue is empty, each lane run alone
    (a pool of one lane, to its fixed point) ends in the state the pool's
    loop leaves it in, in as many iterations as its last one there, and
    the pool's n_rays and n_busy are the sums of the lanes' per iteration."""
    ctx, s, accum = context_and_state(two_level, n_lanes=48)
    s, it0 = until_queue_empty(ctx, s, accum)
    pool, it, last = s, it0, torch.full((48,), it0)
    want = {}  # per iteration: the pool's segment starts and tracking lanes
    while bool(fastq.more(ctx, pool)):
        pending = pool.alive | (pool.pend_pix >= 0)
        last = torch.where(pending, it + 1, last)
        new = fastq.plain_body(ctx, pool, accum, it)
        want[it] = (float(new.n_rays - pool.n_rays),
                    float(new.n_busy - pool.n_busy))
        pool, it = new, it + 1
    got = {e: (0.0, 0.0) for e in want}
    for i in range(48):
        x, e = one_lane(s, i), it0
        while bool(x.alive[0] | (x.pend_pix[0] >= 0)):
            new = fastq.plain_body(ctx, x, torch.zeros_like(accum), e)
            r, b = got[e]
            got[e] = (r + float(new.n_rays - x.n_rays),
                      b + float(new.n_busy - x.n_busy))
            x, e = new, e + 1
        assert e == int(last[i]), i
        for n, v in lanes(x, slice(None)).items():
            assert torch.equal(v[0], stages.lane_field(pool, n)[i]), (i, n)
    assert it == int(last.max()) and got == want


# -- the drain's fold --------------------------------------------------------------------

def fold_counts(counts0, isect, busy):
    """csrc/fastqbody.cu drain_kernel's fold on the host: per iteration of
    the launch its segment starts and tracking lanes (integer counts), each
    rounded to float32 and added in iteration order, and n_iters one more
    each."""
    rays, iters, bsy = (np.float32(c) for c in counts0)
    for ci, cb in zip(isect, busy):
        rays = np.float32(rays + np.float32(ci))
        iters = np.float32(iters + np.float32(1.0))
        bsy = np.float32(bsy + np.float32(cb))
    return float(rays), float(iters), float(bsy)


def loop_counts(counts0, masks):
    """The eager loop's counters: per iteration torch.sum of the masks'
    float32 (exact: each count is under 2^24) added to the 0-d float32."""
    rays, iters, busy = (torch.tensor(c, dtype=torch.float32) for c in counts0)
    for isect, trk in masks:
        rays = rays + torch.sum(isect.to(torch.float32))
        iters = iters + torch.tensor(True)
        busy = busy + torch.sum(trk.to(torch.float32))
    return float(rays), float(iters), float(busy)


@pytest.mark.parametrize("counts0", [
    (0.0, 0.0, 0.0), (123.0, 7.0, 4567.0),
    # past 2^24: each add rounds, the counts are odd
    (float(2 ** 24 - 3), 10.0, float(2 ** 24 + 1)),
    (float(2 ** 25 + 1), 2.0 ** 20, float(2 ** 26 - 1)),
])
def test_drain_fold_equals_loop_sums(counts0):
    """fold_counts (the drain's fold of its per-iteration counts into
    n_rays, n_iters and n_busy) equals the loop's float32 sums bit for bit,
    also where the counters pass 2^24 and every add rounds."""
    rs = np.random.RandomState(int(counts0[0]) % 1000)
    masks = [(torch.tensor(rs.rand(301) < p), torch.tensor(rs.rand(301) < q))
             for p, q in rs.rand(40, 2)]
    isect = [int(m.sum()) for m, _ in masks]
    busy = [int(b.sum()) for _, b in masks]
    assert fold_counts(counts0, isect, busy) == loop_counts(counts0, masks)


# -- the layout and the parameters ----------------------------------------------------

def test_kernel_layout_equals_the_wrapper():
    """csrc/fastqbody.cu's FP_*, IP_*, S_* and SC_* enums give the values
    ops/fastqbody.py packs by; its block, flush and refill cadence are the
    module's and the model's."""
    text = SOURCE.read_text()
    c = enum_values(text)
    py = {k: v for k, v in vars(fastqbody).items()
          if k[:3] in ("FP_", "IP_") or k[:2] in ("S_", "N_")
          and isinstance(v, int) and k not in ("N_CTRL",)}
    lane = dict(zip(("S_O", "S_D", "S_TP", "S_RAD", "S_PRAD", "S_NRM", "S_T",
                     "S_MAXT", "S_ISL", "S_BEXIT", "S_IMG", "S_PEND",
                     "S_ALIVE", "S_TRACK", "S_RS", "S_RINC"),
                    range(fastqbody.N_LANE)))
    assert len(lane) == len(fastqbody.LANE_FIELDS)
    for name, value in py.items():
        if isinstance(value, int):
            assert c[name] == value, name
    for name, k in lane.items():
        assert c[name] == k, name
    assert c["N_SCRATCH"] == fastqbody.N_SCRATCH
    assert f"THREADS = {fastqbody.BLOCK};" in text
    assert f"FLUSH_EVERY = {fastq.FLUSH_EVERY};" in text
    assert f"REFILL_EVERY = {fastq.REFILL_EVERY};" in text


@pytest.mark.parametrize("albedo", ["affine", "const", "full"])
def test_parameters_are_the_eager_values(albedo):
    """The float vector holds the tensors the eager body reads (the box,
    the grid and brick extents, the majorant's reciprocal, epsw, the camera
    and the float32 reciprocals of the Python divisors), the integer one
    the queue, the hashed seed, the table's layout and albedo mode and the
    brick grid."""
    scene, camera, settings, *_ = case_args(albedo=albedo)
    ctx = fastq.make_context(scene, camera, settings, (8, 6),
                             torch.tensor([3.0, 5.0]), (40, 30), 144, 77,
                             (1 << 32) + 9, True)
    f, i = ctx.params()
    med = scene.medium
    assert f[fastqbody.FP_INV_SIGMAT] == ctx.inv_sigmat.item()
    assert f[fastqbody.FP_EPSW] == ctx.epsw.item()
    assert list(f[fastqbody.FP_EXT:fastqbody.FP_EXT + 3]) == ctx.extent.tolist()
    assert list(f[fastqbody.FP_RM1:fastqbody.FP_RM1 + 3]) == [31.0] * 3
    assert list(f[fastqbody.FP_BSIZE:fastqbody.FP_BSIZE + 3]) == [8.0, 4.0, 4.0]
    assert list(f[fastqbody.FP_CAM:fastqbody.FP_CAM + 12]) == (
        camera.inv_view.reshape(-1).tolist())
    assert f[fastqbody.FP_INV_TW] == np.float32(1) / np.float32(8)
    assert f[fastqbody.FP_INV_RESX] == np.float32(1) / np.float32(40)
    assert list(f[fastqbody.FP_TILEX:fastqbody.FP_TILEY + 1]) == [3.0, 5.0]
    assert (i[fastqbody.IP_NPATHS], i[fastqbody.IP_TW],
            i[fastqbody.IP_NPIX]) == (144, 8, 48)
    assert i[fastqbody.IP_BASE] == 9
    assert i[fastqbody.IP_SEEDH] == (77 * 0x9E3779B9) & 0xFFFFFFFF
    bz, by, bx = BRICK
    assert (i[fastqbody.IP_NBX], i[fastqbody.IP_NBY]) == (32 // bx, 32 // by)
    assert list(i[fastqbody.IP_HIX:fastqbody.IP_HIZ + 1]) == [
        32 // bx - 1, 32 // by - 1, 32 // bz - 1]
    assert i[fastqbody.IP_TWO_LEVEL] == 1
    assert i[fastqbody.IP_ALBEDO] == fastqbody.ALBEDO_MODES[albedo]
    assert i[fastqbody.IP_TABLE] == (fastqbody.TAB_ROWS if albedo == "full"
                                     else fastqbody.TAB_F32)
    assert ctx.fused.is_contiguous() and ctx.bm_flat.is_contiguous()
    if albedo == "const":
        assert list(f[fastqbody.FP_ALB_B:fastqbody.FP_ALB_B + 3]) == (
            med.albedo.data.reshape(-1)[:3].tolist())
    if albedo == "affine":
        assert list(f[fastqbody.FP_ALB_A:fastqbody.FP_ALB_A + 3]) == (
            med.albedo_affine[0].tolist())


def test_pointer_slots_hold_the_state():
    """Each per-lane slot points at its field and its out slot at the out
    pool's (or its own in place), the scalars and tables at theirs; a
    partly overlapping out and a wrong dtype raise."""
    ctx, s, accum = context_and_state(True)
    counts = torch.zeros(3)
    prep = fastqbody.KERNEL.prepare(ctx, s, accum, counts)
    ptrs = [x or 0 for x in prep.keep[2]]
    for k, name in enumerate(fastqbody.LANE_FIELDS):
        assert ptrs[k] == ptrs[fastqbody.S_OUT + k] == stages.lane_field(
            s, name).data_ptr(), name
    assert ptrs[fastqbody.S_ISSUED] == ptrs[fastqbody.S_ISSUED_OUT] == (
        s.paths_issued.data_ptr())
    assert ptrs[fastqbody.S_COUNTS] == ptrs[fastqbody.S_COUNTS_OUT] == (
        counts.data_ptr())
    assert ptrs[fastqbody.S_ACCUM] == accum.data_ptr()
    assert ptrs[fastqbody.S_TABLE] == ctx.fused.data_ptr()
    assert ptrs[fastqbody.S_BMAJ] == ctx.bm_flat.data_ptr()
    assert ptrs[fastqbody.S_CTRL] == ptrs[fastqbody.S_EVALS] == 0
    assert prep.keep[1][fastqbody.IP_IT] == 0
    out = fastq.initial_state(64, 5, "cpu")
    prep = fastqbody.KERNEL.prepare(ctx, s, accum, counts, out=out, it=7)
    ptrs = [x or 0 for x in prep.keep[2]]
    assert ptrs[fastqbody.S_OUT] == out.o.data_ptr()
    assert prep.keep[1][fastqbody.IP_IT] == 7
    buf = torch.zeros(65, 3)
    with pytest.raises(ValueError, match="overlaps"):
        fastqbody.KERNEL.prepare(ctx, s._replace(o=buf[:64]), accum, counts,
                                 out=s._replace(o=buf[1:]))
    with pytest.raises(ValueError, match="throughput must be"):
        fastqbody.KERNEL.prepare(ctx, s._replace(
            throughput=s.throughput.double()), accum, counts)


# -- the routing -----------------------------------------------------------------------

def test_routing_keeps_the_cpu_and_eager_body_on_the_plain_body(monkeypatch):
    """route: the kernels on the card only, never with eager_body=True;
    on the CPU a render launches nothing (make_kernel_fn's row passes
    eager_body on); run_body raises on a device without a kernel, and a
    failed build raises."""
    assert fastqbody.route("cuda")
    assert not fastqbody.route("cpu")
    assert not fastqbody.route("cuda", eager_body=True)
    fastqbody.KERNEL.reset()
    fn = make_kernel_fn(Config(kernel=Kernel.FAST_Q, n_lanes=64))
    args = case_args(res=8, spp=1)
    a, ra = fn(*args)
    b, rb = fn(*args, eager_body=True)
    assert torch.equal(a, b) and float(ra) == float(rb)
    assert fastqbody.KERNEL.launches == fastqbody.KERNEL.drain_launches == 0
    assert fastqbody.KERNEL.plain_evals > 0
    ctx, s, accum = context_and_state(False, n_lanes=8)
    meta = s._replace(alive=torch.empty(8, dtype=torch.bool, device="meta"))
    with pytest.raises(ValueError, match="no kernel for device meta"):
        fastqbody.run_body(ctx, meta, accum, 0)

    def broken(source):
        raise RuntimeError("nvcc failed on fastqbody.cu")

    monkeypatch.setattr(cuda_build, "build_library", broken)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        fastqbody.FastQKernel().library()


# -- the bound -------------------------------------------------------------------------

def test_fastq_bytes_counts_lanes_tables_and_pixels():
    """fastq_bytes: the fields each lane reads and changes at their sizes
    (a lane at the fixed point its alive flag and pending pixel, 9 B), each
    distinct table entry (4 B; a 'full' row 16 B) and brick majorant (4 B)
    once, each flushed pixel read and written (24 B); an evaluation that
    reads a field another wrote reads it once."""
    ctx, s0, accum = context_and_state(True)
    s = s0
    for it in range(3):
        s = fastq.plain_body(ctx, s, accum, it)
    taps = []
    s1 = fastq.plain_body(ctx, s, accum, 3, taps=taps)
    state = [x for k, x in taps if k == "state"]
    assert len(state) == 1
    tr = state[0]
    lanes_b = sum(fastqbody.FIELD_BYTES[n] * int(r.sum() + w.sum())
                  for n, (r, w) in tr.items())
    tap = int(torch.unique(torch.cat([x for k, x in taps if k == "tap"]))
              .numel())
    brick = int(torch.unique(torch.cat(
        [x for k, x in taps if k == "brick"])).numel())
    assert tap > 0 and brick > 0
    assert fastqbody.fastq_bytes(ctx, taps) == lanes_b + 4 * tap + 4 * brick
    # every lane dead with a free slot, the queue empty: 9 B a lane
    done = s0._replace(paths_issued=torch.tensor(ctx.n_paths))
    taps = []
    fastq.plain_body(ctx, done, accum, 0, taps=taps)
    assert fastqbody.fastq_bytes(ctx, taps) == 9 * 64
    # a flushed pixel: read and written once
    assert fastqbody.fastq_bytes(ctx, [("accum", torch.tensor([4, 4, 9]))]) == 48
    # two evaluations: the second reads what the first wrote once
    taps = []
    s2 = fastq.plain_body(ctx, s1, accum, 4, taps=taps)
    both = stages.Traffic(fastqbody.FIELD_BYTES, {}).add(
        [x for x in taps if x[0] == "state"])
    assert both.total() > 0 and s2.alive.any()
