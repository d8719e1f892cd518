"""Streaming scheduler: fully fused single-step wavefront state machine.

Port of cudavolumerenderer_tpu/models/streaming.py, the analog of
streamingSK and sortingSK (reference: StreamingVolPTsk_kernel.cuh:27-360,
SortingVolPTsk_kernel.cuh).  Every iteration does a constant amount of
work per lane:

  1. dead lanes are refilled from the deterministic path queue;
  2. lanes between segments run the AABB test and classify their event;
  3. tracking lanes take exactly one Woodcock step (one density gather);
  4. lanes whose segment terminated run their scatter/boundary event and
     Russian roulette.

There is no nested tracking loop: a lane that finishes its free flight
goes on to its event and next segment while neighbours keep stepping.
Per-lane RNG draw order is the naive scheduler's, so both give the same
estimate for the same (seed, path id).  sortingSK adds a Morton reorder
of the pool every `sort_every` iterations and, with `defer_access`, the
deferred coherent albedo fetch right after each sort.

Port note: the lax.while_loop is a host loop that reads its condition
once every `check_every` iterations (an iteration after the last path
finished changes nothing, so the image does not depend on it); the
lax.cond on `it % sort_every` is a Python `if` on the host's iteration
counter, so the sort and the deferred flush fall on the JAX package's
iterations; the three argsorts are stable, as jnp.argsort is.  On the card
each iteration is a refill and an extend (and the flush) of
csrc/familybody.cu, in gated chains read once per batch, and each sort
point csrc/lanesort.cu's gated radix sort of the pool in place
(ops/familybody.stream_loop, ops/lanesort.py); `_morton_reorder` below
stays the plain version, which the CPU and `eager_body=True` run.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..constants import EPSILON
from ..ops import aabb, camera as cam, familybody, morton, phase, stages
from ..ops import woodcock
from ..ops.grid import tap_voxels
from ..ops.rng import RngState
from ..scene.types import RenderSettings, Scene
from . import integrator
from .fast import _take_lanes
from .regeneration import empty_pool, queue_refill

#: iterations per host read of the loop condition
CHECK_EVERY = 8


class StreamState(NamedTuple):
    o: torch.Tensor  # (N, 3)
    d: torch.Tensor  # (N, 3)
    throughput: torch.Tensor  # (N, 3)
    radiance: torch.Tensor  # (N, 3)
    alive: torch.Tensor  # (N,)
    tracking: torch.Tensor  # (N,) mid-free-flight
    t: torch.Tensor  # (N,) current tracking distance
    max_t: torch.Tensor  # (N,) boundary distance for this segment
    normal: torch.Tensor  # (N, 3) cached boundary normal for this segment
    image_id: torch.Tensor  # (N,) int64
    rng: RngState
    n_rays: torch.Tensor  # ()
    # sortingSK deferred texture access: lanes that scattered but have not
    # yet fetched their albedo (reference: temp_storage.texture_access,
    # SortingVolPTsk_kernel.cuh:232-241); p_scat is the saved fetch point
    pending: torch.Tensor  # (N,) bool
    p_scat: torch.Tensor  # (N, 3)


def initial_stream_state(n_lanes: int, seed, device) -> StreamState:
    """An all-dead pool; the first refill fills it."""
    zeros1 = torch.zeros((n_lanes,), dtype=torch.float32, device=device)
    false = torch.zeros((n_lanes,), dtype=torch.bool, device=device)
    return StreamState(
        **empty_pool(n_lanes, seed, device),
        tracking=false, t=zeros1, max_t=zeros1,
        normal=torch.zeros((n_lanes, 3), dtype=torch.float32, device=device),
        image_id=torch.zeros((n_lanes,), dtype=torch.int64, device=device),
        pending=false,
        p_scat=torch.zeros((n_lanes, 3), dtype=torch.float32, device=device),
    )


def _refill(
    s: StreamState,
    paths_issued,
    n_paths: int,
    tile_dim,
    tile_offset,
    full_resolution,
    camera,
    seed,
    path_id_base,
):
    takes, image_id_new, o_new, d_new, rng, paths_issued = queue_refill(
        torch.logical_not(s.alive), s.rng, paths_issued, n_paths, tile_dim,
        tile_offset, full_resolution, camera, seed, path_id_base,
    )
    m = takes[..., None]
    return (
        s._replace(
            o=torch.where(m, o_new, s.o),
            d=torch.where(m, d_new, s.d),
            throughput=torch.where(m, 1.0, s.throughput),
            radiance=torch.where(m, 0.0, s.radiance),
            alive=torch.logical_or(s.alive, takes),
            tracking=torch.where(takes, False, s.tracking),
            rng=rng,
            image_id=torch.where(takes, image_id_new, s.image_id),
        ),
        paths_issued,
    )


def _morton_reorder(s: StreamState, box_min, box_max) -> StreamState:
    """Permute the lane pool into Morton order of current positions, the
    sortingSK re-expression (reference: SortingVolPTsk_kernel.cuh:149-176,
    MortonSort.h:12-68).  Dead lanes sort to the tail, which doubles as
    compaction.  The sort is stable: dead lanes tie on DEAD_KEY."""
    keys = morton.ray_sort_keys(s.o, box_min, box_max, s.alive)
    return _take_lanes(s, torch.argsort(keys, stable=True))


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
    sort_every: int = 0,
    defer_access: bool = False,
    check_every: int = CHECK_EVERY,
    eager_body: bool = False,
):
    """Render a tile; returns (accum (th, tw, 3), n_rays)."""
    if defer_access and sort_every <= 0:
        raise ValueError("defer_access requires sort_every > 0")
    dev = scene.device
    tile_offset = torch.as_tensor(tile_offset, dtype=torch.float32, device=dev)
    tw, th = tile_dim
    n_pix = tw * th
    n_paths = n_pix * spp
    n_lanes = min(n_lanes, n_paths)

    s = initial_stream_state(n_lanes, seed, dev)
    accum = torch.zeros((n_pix, 3), dtype=torch.float32, device=dev)
    paths_issued = torch.zeros((), dtype=torch.int64, device=dev)

    ctx = familybody.make_context(
        scene, settings, camera, tile_dim, tile_offset, full_resolution,
        n_paths, seed, path_id_base)
    s, _ = familybody.stream_loop(
        ctx, s, paths_issued, accum, sort_every=sort_every,
        defer=defer_access, check_every=check_every,
        kernel=familybody.route(dev.type, eager_body))
    return accum.reshape(th, tw, 3), s.n_rays


def _splat_taps(taps, s, new, reads, died, scene, settings, points, fetch):
    """A step's traffic into `taps` (ops/familybody.family_bytes): the
    per-lane fields, the albedo voxels at `points` of the `fetch` lanes and
    the pixels the lanes that `died` add to."""
    med = scene.medium
    p01 = aabb.aabb_transform(med.box_min, med.box_max, points)
    taps += [("albedo", tap_voxels(med.albedo, p01,
                                   settings.interpolation)[fetch]),
             ("accum", s.image_id[died]),
             ("state", stages.lane_traffic(s, new, reads,
                                           familybody.LANE_FIELDS))]


def extend_step(
    scene: Scene, settings: RenderSettings, s: StreamState,
    accum: torch.Tensor, defer_albedo: bool = False, taps=None,
):
    """One fused streaming step (phases 2-4 + Russian roulette) for every
    lane, and a masked splat of finished paths into `accum` (in place).
    The shared 'extend' body of streamingSK and streamingMK (reference:
    StreamingVolPTmk_kernel.cuh:72-254).

    defer_albedo=True is sortingSK's mechanic: a lane that scatters
    records the fetch point and stalls instead of gathering its albedo;
    flush_pending performs all outstanding fetches after the Morton sort
    (reference: SortingVolPTsk_kernel.cuh:105-147,232-241).  The RR draw
    moves with the fetch, still after the phase draw in the path's own
    stream, so estimates are identical lane for lane.  A list given as
    `taps` receives the step's traffic (ops/familybody.family_bytes)."""
    med = scene.medium
    was_alive = s.alive

    # --- phase 2: segment start — AABB test + event classification ---
    # pending lanes are stalled: they neither start a segment nor step
    need_isect = torch.logical_and(s.alive, torch.logical_not(s.tracking))
    if defer_albedo:
        need_isect = torch.logical_and(need_isect, torch.logical_not(s.pending))
    n_rays = s.n_rays + torch.sum(need_isect.to(torch.float32))
    isect = aabb.aabb_intersect(med.box_min, med.box_max, s.o, s.d)

    miss = torch.logical_and(need_isect, torch.logical_not(isect.hit))
    radiance = torch.where(
        miss[..., None], s.radiance + s.throughput * scene.le, s.radiance
    )
    alive = torch.logical_and(s.alive, torch.logical_not(miss))

    hit = torch.logical_and(need_isect, isect.hit)
    enters_medium = torch.logical_and(hit, isect.inside_volume)
    boundary_now = torch.logical_and(hit, torch.logical_not(isect.inside_volume))
    tracking = torch.logical_or(s.tracking, enters_medium)
    t = torch.where(enters_medium, 0.0, s.t)
    max_t = torch.where(enters_medium, isect.dist, s.max_t)
    normal = torch.where(need_isect[..., None], isect.normal, s.normal)

    # --- phase 3: one Woodcock step for tracking lanes ----------------
    # fresh segments start stepping next iteration
    step_mask = torch.logical_and(tracking, torch.logical_not(enters_medium))
    t, terminated, scattered, rng = woodcock.woodcock_step_masked(
        med.density, med.box_min, med.box_max, med.scale, med.max_density,
        s.o, s.d, t, max_t, s.rng, step_mask, settings.interpolation,
        taps=taps,
    )
    tracking = torch.logical_and(tracking, torch.logical_not(terminated))
    overran = torch.logical_and(terminated, torch.logical_not(scattered))

    # --- phase 4a: boundary event (fresh outside-hit or overrun) ------
    boundary = torch.logical_or(boundary_now, overran)
    o_bound = torch.where(
        boundary_now[..., None],
        s.o + s.d * isect.dist[..., None],
        s.o + s.d * max_t[..., None],
    )
    o_b_out, d_b_out, t_b_out, rng = integrator.boundary_event(
        scene, settings, normal, o_bound, s.d, s.throughput, rng, boundary
    )

    # --- phase 4b: medium scatter event -------------------------------
    o_scat = s.o + s.d * t[..., None] - s.d * EPSILON
    d_scat, rng = phase.sample_phase(s.d, med.g, rng, active=scattered)

    sc, bd = scattered[..., None], boundary[..., None]
    o = torch.where(sc, o_scat, torch.where(bd, o_b_out, s.o))
    d = torch.where(sc, d_scat, torch.where(bd, d_b_out, s.d))
    had_event = torch.logical_and(alive, torch.logical_or(scattered, boundary))
    if defer_albedo:
        # record the fetch and stall the lane; the throughput multiply and
        # the scatter's RR run at flush_pending after the next sort
        throughput = torch.where(bd, t_b_out, s.throughput)
        pending = torch.logical_or(s.pending, scattered)
        p_scat = torch.where(sc, o_scat, s.p_scat)
        had_event = torch.logical_and(had_event, torch.logical_not(scattered))
    else:
        albedo = integrator.sample_albedo(scene, o_scat, settings)
        throughput = torch.where(
            sc, s.throughput * albedo, torch.where(bd, t_b_out, s.throughput)
        )
        pending, p_scat = s.pending, s.p_scat

    # --- Russian roulette after any event ------------------------------
    if settings.russian_roulette:
        throughput, alive, _, rng = integrator.russian_roulette(
            throughput, alive, rng, had_event
        )

    died = torch.logical_and(was_alive, torch.logical_not(alive))
    accum.index_add_(0, s.image_id, torch.where(died[..., None], radiance, 0.0))
    radiance = torch.where(died[..., None], 0.0, radiance)

    new = s._replace(
        o=o, d=d, throughput=throughput, radiance=radiance,
        alive=alive, tracking=tracking, t=t, max_t=max_t,
        normal=normal, rng=rng, pending=pending, p_scat=p_scat,
        n_rays=n_rays,
    )
    if taps is not None:
        # the lanes whose step reads each field before it writes it
        none = torch.zeros_like(s.alive)
        ggx_on = settings.bsdf_kind == "ggx"
        fetch = none if defer_albedo else scattered
        reads = {
            "alive": torch.ones_like(s.alive),
            "tracking": torch.ones_like(s.alive),
            "pending": (s.alive & ~s.tracking) if defer_albedo else none,
            "o": s.alive | s.tracking, "d": s.alive | s.tracking,
            "throughput": (miss | fetch | (boundary if ggx_on else none)
                           | (had_event if settings.russian_roulette
                              else none)),
            "radiance": miss | died, "image_id": died,
            "t": step_mask, "max_t": step_mask,
            "normal": (overran if ggx_on else none), "p_scat": none,
        }
        _splat_taps(taps, s, new, reads, died, scene, settings, o_scat,
                    fetch)
    return new, accum


def flush_pending(
    scene: Scene, settings: RenderSettings, s: StreamState,
    accum: torch.Tensor, taps=None,
):
    """Perform all deferred albedo fetches as one batched gather
    (reference: swapThreadAndAccessTexture,
    SortingVolPTsk_kernel.cuh:105-147), apply the deferred throughput
    multiply, and run the deferred scatter-event Russian roulette.  A list
    given as `taps` receives the flush's traffic."""
    before = s
    was_alive = s.alive
    albedo = integrator.sample_albedo(scene, s.p_scat, settings)
    throughput = torch.where(
        s.pending[..., None], s.throughput * albedo, s.throughput
    )
    alive, rng = s.alive, s.rng
    if settings.russian_roulette:
        throughput, alive, _, rng = integrator.russian_roulette(
            throughput, alive, rng, s.pending
        )
        died = torch.logical_and(was_alive, torch.logical_not(alive))
        accum.index_add_(
            0, s.image_id, torch.where(died[..., None], s.radiance, 0.0)
        )
        s = s._replace(radiance=torch.where(died[..., None], 0.0, s.radiance))
    else:
        died = torch.zeros_like(s.alive)
    new = s._replace(
        throughput=throughput, alive=alive, rng=rng,
        pending=torch.zeros_like(s.pending),
    )
    if taps is not None:
        none = torch.zeros_like(s.alive)
        reads = {n: none for n in familybody.LANE_FIELDS
                 if not n.startswith("rng")}
        reads.update(pending=torch.ones_like(s.alive),
                     throughput=before.pending, p_scat=before.pending,
                     radiance=died, image_id=died)
        if settings.russian_roulette:
            reads["alive"] = before.pending
        _splat_taps(taps, before, new, reads, died, scene, settings,
                    before.p_scat, before.pending)
    return new, accum
