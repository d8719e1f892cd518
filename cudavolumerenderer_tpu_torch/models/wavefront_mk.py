"""Host-looped multi-kernel schedulers: naiveMK and streamingMK analogs.

Port of cudavolumerenderer_tpu/models/wavefront_mk.py.  The reference's
MK family returns control to the host between bounces (reference:
NaiveVolPTmk's launcher loop RenderKernelLauncher.cu:183-276 with thrust
stream compaction, and StreamingVolPTmk's regenerate/extend ping-pong,
RenderKernelLauncher.cu:435-472).  The analog is a Python loop of small
steps with a device→host read of the active count per dispatch, the
dispatch overhead the thesis measures for these strategies; they are
here for parity and as the scheduling-overhead baseline, not for speed.

naiveMK    : one bounce per host step over a full path batch, with
             device-side compaction (stable sort by alive) between bounces.
streamingMK: host-looped regenerate → extend → compact super-iterations
             over the streaming pool.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..ops import camera as cam
from ..ops import familybody
from ..scene.types import RenderSettings, Scene
from . import integrator, naive, streaming
from .fast import _take_lanes


def _alive_first(alive: torch.Tensor) -> torch.Tensor:
    """The permutation that moves live lanes to the front, keeping their
    order (thrust::remove_if's, RenderKernelLauncher.cu:266-275)."""
    return torch.argsort(torch.logical_not(alive).to(torch.uint8), stable=True)


def _compact(state: integrator.PathState, image_id: torch.Tensor):
    """Device-side stream compaction of a naiveMK batch."""
    order = _alive_first(state.alive)
    return _take_lanes(state, order), image_id.index_select(0, order)


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
    compaction: bool = True,
    eager_body: bool = False,
):
    """naiveMK: host-controlled wavefront, one bounce per dispatch (on the
    card one launch of csrc/familybody.cu's bounce, whose alive count is
    the host's read; the compaction stays torch)."""
    tile_offset = torch.as_tensor(tile_offset, dtype=torch.float32,
                                  device=scene.device)
    image_id, state = naive.start_batch(camera, tile_dim, tile_offset,
                                        full_resolution, spp, seed,
                                        path_id_base)
    ctx = familybody.make_context(scene, settings)
    kernel = familybody.route(scene.device.type, eager_body)
    if kernel:
        state = familybody.own(state)
        count = torch.empty((), dtype=torch.int64, device=scene.device)
        bounce = familybody.KERNEL.prepare(ctx, "bounce", state, count=count)
    for _ in range(settings.max_path_length):
        if kernel:
            familybody.KERNEL.launch(bounce, scene.device)
        else:
            state, _ = familybody.plain_body(ctx, "bounce", state)
        familybody.KERNEL.evals += 1
        # device→host read of the active count, as in the reference
        if familybody.KERNEL.read(count if kernel
                                  else torch.sum(state.alive)) == 0:
            break
        if compaction:
            compacted, image_id = _compact(state, image_id)
            if kernel:
                familybody.copy_lanes_(state, compacted)
            else:
                state = compacted

    return naive.splat(image_id, state.radiance, tile_dim), state.n_rays


def _compact_stream(s: streaming.StreamState) -> streaming.StreamState:
    """Device-wide compaction of the streaming pool: survivors to the
    front, dead lanes as a contiguous tail (the cub ExclusiveSum scan +
    scatter of StreamingVolPTmk_kernel.cuh:218-253, as one stable argsort
    permutation)."""
    return _take_lanes(s, _alive_first(s.alive))


def _super_iteration(ctx, s, paths_issued, accum, k_steps):
    """d_regenerate + d_extend + compaction as one dispatch (reference:
    the per-super-iteration launch pair, RenderKernelLauncher.cu:440-458);
    k_steps streaming steps play the extend kernel's inner bounce loop
    (StreamingVolPTmk_kernel.cuh:162-216).  The plain bodies."""
    s, _, paths_issued = familybody.plain_body(ctx, "refill", s,
                                               issued=paths_issued)
    for _ in range(k_steps):
        s, _ = familybody.plain_body(ctx, "extend", s, accum=accum)
    familybody.KERNEL.evals += k_steps
    s = _compact_stream(s)
    return s, paths_issued, torch.sum(s.alive)


def render_tile_streaming_mk(
    scene: Scene,
    camera: cam.Camera,
    settings: RenderSettings,
    tile_dim: Tuple[int, int],
    tile_offset,
    full_resolution: Tuple[int, int],
    spp: int,
    seed,
    path_id_base,
    n_lanes: int = 1 << 14,
    k_steps: int = 8,
    eager_body: bool = False,
):
    """streamingMK: the host drives regenerate/extend super-iterations
    over a fixed pool and reads the active count back each dispatch
    (reference: the `while (n_active || queue)` host loop,
    RenderKernelLauncher.cu:435-472).  Same per-path streams as
    streamingSK and naiveSK, so the estimate is identical lane for lane.
    On the card a super-iteration is one refill and k_steps extend
    launches of csrc/familybody.cu, then the torch compaction."""
    dev = scene.device
    tile_offset = torch.as_tensor(tile_offset, dtype=torch.float32, device=dev)
    tw, th = tile_dim
    n_pix = tw * th
    n_paths = n_pix * spp
    n_lanes = min(n_lanes, n_paths)

    s = streaming.initial_stream_state(n_lanes, seed, dev)
    accum = torch.zeros((n_pix, 3), dtype=torch.float32, device=dev)
    paths_issued = torch.zeros((), dtype=torch.int64, device=dev)
    ctx = familybody.make_context(
        scene, settings, camera, tile_dim, tile_offset, full_resolution,
        n_paths, seed, path_id_base)
    if familybody.route(dev.type, eager_body):
        return _streaming_mk_kernels(ctx, s, paths_issued, accum, k_steps)
    while True:
        s, paths_issued, n_active = _super_iteration(
            ctx, s, paths_issued, accum, k_steps)
        # device→host read each super-iteration, as in the reference
        if (familybody.KERNEL.read(n_active) == 0
                and familybody.KERNEL.read(paths_issued) >= n_paths):
            break
    return accum.reshape(th, tw, 3), s.n_rays


def _streaming_mk_kernels(ctx, s, paths_issued, accum, k_steps):
    """streamingMK's super-iterations on the card: a refill and k_steps
    extends of csrc/familybody.cu on a pool whose buffers stay put (the
    compaction copied back into them), the active count and paths_issued
    read once per super-iteration."""
    kern, dev = familybody.KERNEL, accum.device
    s, paths_issued = familybody.own(s), paths_issued.clone()
    count = torch.empty((), dtype=torch.int64, device=dev)
    refill = kern.prepare(ctx, "refill", s, issued=paths_issued)
    extend = kern.prepare(ctx, "extend", s, accum=accum, count=count)
    while True:
        kern.launch(refill, dev)
        for _ in range(k_steps):
            kern.launch(extend, dev)
        kern.evals += k_steps
        familybody.copy_lanes_(s, _compact_stream(s))
        n_active, issued = kern.read(torch.stack([count, paths_issued]))
        if n_active == 0 and issued >= ctx.n_paths:
            break
    tw, th = ctx.tile_dim
    return accum.reshape(th, tw, 3), s.n_rays
