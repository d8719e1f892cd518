"""Naive megakernel scheduler: one lane per path, no regeneration.

Port of cudavolumerenderer_tpu/models/naive.py, the analog of naiveSK
(reference: NaiveVolPTsk_kernel.cuh, RenderKernelLauncher.cu:131-158):
every path of the tile batch gets a lane up front and the wavefront runs
the shared bounce loop until all lanes die.  Dead lanes idle until the
slowest path finishes, the inefficiency the reference measures for this
strategy, as masked lanes instead of idle CUDA threads.

On the card the loop is one launch of csrc/familybody.cu's drain: every
lane bounces in registers until it dies, the reference's megakernel
(ops/familybody.trace); the CPU and `eager_body=True` run the eager loop.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..ops import camera as cam
from ..ops import familybody
from ..ops.rng import as_u32, make_rng
from ..scene.types import RenderSettings, Scene
from . import integrator


def lane_pixels(
    n_lanes: int, tile_dim: Tuple[int, int], tile_offset: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Lane → (image_id, pixel_xy), the reference's tid % n_pixels layout
    (NaiveVolPTsk_kernel.cuh:22-27)."""
    tw, th = tile_dim
    lane = torch.arange(n_lanes, dtype=torch.int64, device=tile_offset.device)
    image_id = lane % (tw * th)
    px = (image_id % tw).to(torch.float32) + tile_offset[0]
    py = torch.floor(image_id.to(torch.float32) / tw) + tile_offset[1]
    return image_id, torch.stack([px, py], dim=-1)


def start_batch(camera, tile_dim, tile_offset, full_resolution, spp: int,
                seed, path_id_base):
    """One lane per path of the tile batch, every lane alive with its
    camera ray: (image_id, PathState).  Shared with naiveMK."""
    dev = tile_offset.device
    tw, th = tile_dim
    n_lanes = tw * th * spp
    image_id, pixel_xy = lane_pixels(n_lanes, tile_dim, tile_offset)
    path_id = as_u32(
        torch.arange(n_lanes, dtype=torch.int64, device=dev)
        + as_u32(path_id_base, dev)
    )
    o, d, rng = cam.generate_rays(camera, pixel_xy, full_resolution,
                                  make_rng(seed, path_id))
    return image_id, integrator.initial_state(o, d, rng)


def splat(image_id, radiance, tile_dim) -> torch.Tensor:
    """Sum each lane's radiance into its pixel: the (th, tw, 3) image."""
    tw, th = tile_dim
    accum = torch.zeros((tw * th, 3), dtype=torch.float32,
                        device=radiance.device)
    accum.index_add_(0, image_id, radiance)
    return accum.reshape(th, tw, 3)


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
    eager_body: bool = False,
):
    """Render spp samples for every pixel of a tile in one wavefront.

    Returns (accum, n_rays): accum is the (th, tw, 3) *sum* of radiance
    samples.  path_id_base offsets the global path ids so successive
    progressive launches use fresh RNG streams (reference: seed_ +=
    n_paths on reset, RenderKernelLauncher.cu:353-361).
    """
    tile_offset = torch.as_tensor(tile_offset, dtype=torch.float32,
                                  device=scene.device)
    image_id, state = start_batch(camera, tile_dim, tile_offset,
                                  full_resolution, spp, seed, path_id_base)
    final = familybody.trace(
        familybody.make_context(scene, settings), state,
        familybody.route(scene.device.type, eager_body))
    return splat(image_id, final.radiance, tile_dim), final.n_rays
