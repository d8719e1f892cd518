"""Regeneration scheduler: persistent wavefront + deterministic work queue.

Port of cudavolumerenderer_tpu/models/regeneration.py, the analog of
regenerationSK (reference: RegenerationVolPTsk_kernel.cuh:147-232,
RenderKernelLauncher.cu:281-351): a fixed pool of lanes runs bounce after
bounce; whenever a lane's path dies it pulls a fresh path id from the
work queue.  The reference's `atomicAdd(&paths_head_global, 1)` becomes
a deterministic prefix-sum allocation over the dead-lane mask, and dead
lanes splat their radiance into the tile accumulator with a masked
scatter-add (the reference's atomicVectorAdd, Utilities.cuh:15-22).

Port note: the lax.while_loop is a host loop that reads its condition
once per iteration; the image is accumulated with index_add_.  On the card
each iteration is a refill and a bounce (with the splat) of
csrc/familybody.cu, in gated chains read once per batch
(ops/familybody.regenerate_loop).
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..ops import camera as cam
from ..ops import familybody
from ..ops.rng import RngState, as_u32, make_rng
from ..scene.types import RenderSettings, Scene
from . import integrator

#: refill group of each regeneration level (reference:
#: REGENERATION_SYNCHRONIZATION_LEVEL 0/1/2: thread, warp, block)
LEVEL_GROUPS = {0: 1, 1: 8, 2: 1024}


def queue_refill(dead, rng: RngState, paths_issued, n_paths: int, tile_dim,
                 tile_offset, full_resolution, camera, seed, path_id_base):
    """The deterministic work queue shared by the queue-fed schedulers:
    the k-th `dead` lane takes path id paths_issued + k while ids last,
    with a fresh RNG stream and its camera ray.  Returns (takes,
    image_id_new, o_new, d_new, rng', paths_issued'); rng' differs from
    rng only on the lanes that took a path."""
    tw, th = tile_dim
    rank = torch.cumsum(dead.to(torch.int64), 0) - 1
    new_id = paths_issued + rank
    takes = torch.logical_and(dead, new_id < n_paths)
    pid = torch.where(takes, new_id, 0)
    image_id_new = pid % (tw * th)
    px = (image_id_new % tw).to(torch.float32) + tile_offset[0]
    py = torch.floor(image_id_new.to(torch.float32) / tw) + tile_offset[1]
    fresh = make_rng(seed, as_u32(pid + as_u32(path_id_base, dead.device)))
    rng = RngState(
        state=torch.where(takes, fresh.state, rng.state),
        inc=torch.where(takes, fresh.inc, rng.inc),
    )
    o_new, d_new, rng = cam.generate_rays(
        camera, torch.stack([px, py], dim=-1), full_resolution, rng,
        active=takes,
    )
    n_taken = torch.sum(takes.to(torch.int64))
    return takes, image_id_new, o_new, d_new, rng, paths_issued + n_taken


def _regenerate(
    carry_state: integrator.PathState,
    image_id: torch.Tensor,
    paths_issued: torch.Tensor,
    n_paths: int,
    tile_dim: Tuple[int, int],
    tile_offset: torch.Tensor,
    full_resolution: Tuple[int, int],
    camera: cam.Camera,
    seed,
    path_id_base,
    refill_group: int = 1,
):
    """Refill dead lanes with fresh paths from the deterministic queue.

    refill_group is the reference's regeneration granularity axis
    (RegenerationVolPTsk_kernel.cuh:22-141,238-352): a group of
    `refill_group` consecutive lanes refills only once every lane in the
    group is dead, and then refills together; lanes past a non-multiple
    tail refill one by one.  The estimator is unchanged (streams stay
    keyed by (seed, path_id)); only queue-pull cadence and idle time
    differ, the axis thesis Tables 4.3/4.4 measure.
    """
    dead = torch.logical_not(carry_state.alive)
    if refill_group > 1:
        g = refill_group
        n_full = (dead.shape[0] // g) * g
        if n_full > 0:
            dead_g = torch.all(dead[:n_full].reshape(-1, g), dim=1)
            dead = torch.cat(
                [torch.repeat_interleave(dead_g, g), dead[n_full:]]
            )
    takes, image_id_new, o_new, d_new, rng, paths_issued = queue_refill(
        dead, carry_state.rng, paths_issued, n_paths, tile_dim, tile_offset,
        full_resolution, camera, seed, path_id_base,
    )
    m = takes[..., None]
    state = integrator.PathState(
        o=torch.where(m, o_new, carry_state.o),
        d=torch.where(m, d_new, carry_state.d),
        throughput=torch.where(m, 1.0, carry_state.throughput),
        radiance=torch.where(m, 0.0, carry_state.radiance),
        alive=torch.logical_or(carry_state.alive, takes),
        rng=rng,
        n_rays=carry_state.n_rays,
    )
    image_id = torch.where(takes, image_id_new, image_id)
    return state, image_id, paths_issued


def empty_pool(n_lanes: int, seed, device) -> dict:
    """Fields of an all-dead lane pool (the first iteration fills it)."""
    zeros3 = torch.zeros((n_lanes, 3), dtype=torch.float32, device=device)
    return dict(
        o=zeros3,
        d=torch.tensor([0.0, 0.0, 1.0], device=device).repeat(n_lanes, 1),
        throughput=torch.ones((n_lanes, 3), dtype=torch.float32, device=device),
        radiance=zeros3,
        alive=torch.zeros((n_lanes,), dtype=torch.bool, device=device),
        rng=make_rng(seed, torch.zeros((n_lanes,), dtype=torch.int64,
                                       device=device)),
        n_rays=torch.zeros((), dtype=torch.float32, device=device),
    )


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
    refill_group: int = 1,
    eager_body: bool = False,
):
    """Render a tile with a fixed lane pool regenerated from a path queue.

    n_paths = tile pixels × spp (reference: setNIterations,
    RenderKernelLauncher.cu:122-127); the pool size n_lanes plays the
    role of the persistent-thread grid size.  Returns (accum, n_rays).
    """
    dev = scene.device
    tile_offset = torch.as_tensor(tile_offset, dtype=torch.float32, device=dev)
    tw, th = tile_dim
    n_pix = tw * th
    n_paths = n_pix * spp
    n_lanes = min(n_lanes, n_paths)

    accum = torch.zeros((n_pix, 3), dtype=torch.float32, device=dev)
    state = integrator.PathState(**empty_pool(n_lanes, seed, dev))
    image_id = torch.zeros((n_lanes,), dtype=torch.int64, device=dev)
    paths_issued = torch.zeros((), dtype=torch.int64, device=dev)

    ctx = familybody.make_context(
        scene, settings, camera, tile_dim, tile_offset, full_resolution,
        n_paths, seed, path_id_base, group=refill_group)
    state, _ = familybody.regenerate_loop(
        ctx, state, image_id, paths_issued, accum,
        familybody.route(dev.type, eager_body))
    return accum.reshape(th, tw, 3), state.n_rays
