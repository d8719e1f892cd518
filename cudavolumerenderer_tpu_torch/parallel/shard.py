"""Sharded rendering and sharded inverse-rendering steps over a process
group (port of cudavolumerenderer_tpu/parallel/shard.py).

Samples (paths) are split across the ranks of the 'rays' axis: each rank
renders a disjoint block of path ids for the same image with its own
deterministic RNG streams, and the partial images are summed with
`all_reduce(SUM)` (JAX's psum).  Voxel grids are replicated: every rank
holds the whole scene on its device.  The inverse step averages the
per-voxel cotangent grids the same way (JAX's pmean).

Path RNG streams depend only on (seed, path_id), so the sharded image
equals the single-device image with the same total spp up to the order
of the float32 sum over ranks; with one rank it is that image bit for
bit.
"""

from __future__ import annotations

from typing import Callable, Sequence, Tuple

import torch
import torch.distributed as dist

from ..models import fast, naive, streaming
from ..models.differentiable import render_diff
from ..ops.camera import Camera
from ..ops.rng import M32
from ..scene.types import RenderSettings, Scene
from .mesh import Mesh

#: the device salt of make_inverse_step's per-rank seed (JAX shard.py:176)
SEED_SALT = 0x9E3779B9


def _check_device(mesh: Mesh, device: torch.device, what: str) -> None:
    if torch.device(device) != mesh.device:
        raise ValueError(
            f"{what} is on {device} but rank {mesh.rank} renders on "
            f"{mesh.device}; build it there"
        )


def shard_base(path_id_base, rank: int, block: int):
    """Rank `rank`'s first path id, path_id_base + rank * block wrapped
    to uint32 as JAX's `jnp.uint32` sum does: an int for an int base, an
    int64 tensor of uint32 words for a (T,) tensor of tile bases."""
    if isinstance(path_id_base, torch.Tensor):
        return (path_id_base.to(torch.int64) + rank * block) & M32
    return (int(path_id_base) + rank * block) & M32


def device_seed(seed, rank: int) -> int:
    """make_inverse_step's seed of rank `rank`: seed + rank * 0x9E3779B9
    mod 2^32 (JAX's uint32 arithmetic)."""
    return (int(seed) + rank * SEED_SALT) & M32


def render_sharded(
    scene: Scene,
    camera: Camera,
    settings: RenderSettings,
    resolution: Tuple[int, int],
    spp: int,
    seed: int,
    mesh: Mesh,
    kernel: str = "streaming",
    n_lanes: int = 1 << 16,
    two_level: bool = False,
    lanes_per_pixel: int = 1,
    tile_dim: Tuple[int, int] = None,
    tile_offset=None,
    path_id_base=0,
    **fast_kwargs,
):
    """Render `spp` total samples per pixel split over the mesh's ranks.
    Every rank calls this with the same arguments (its scene and camera
    on its own device) and every rank returns the reduced
    (image, n_rays): the sum of radiance samples and a float32 ray count.

    kernel: 'streaming' | 'naive' | 'fast' (fastSK, optionally two-level;
    extra keyword arguments go to fast.render_tile, e.g. cascade_factor,
    min_width, table_bits, tail_pallas).  Rank r renders spp // N samples
    from path id path_id_base + r * n_pix * (spp // N); the spp % N
    remainder samples come from path_id_base + n_pix * (spp // N) * N and
    are rendered by rank 0 alone (JAX renders them on every device and
    masks all but shard 0's, an SPMD rule torch does not have), so the
    path ids of all ranks are the single-device render's.

    tile_dim / tile_offset render one tile of a larger `resolution`
    image; with kernel 'fast' a (T, 2) tile_offset and a (T,) tensor
    path_id_base render T tiles in one cascade (multi-tile lane mode) and
    the image is (T, th, tw, 3)."""
    if kernel not in ("fast", "streaming", "naive"):
        raise ValueError(f"kernel {kernel!r}: 'fast', 'streaming' or 'naive'")
    n = mesh.world_size
    spp_shard, spp_rem = divmod(spp, n)
    if tile_dim is None:
        tile_dim = resolution
    dev = mesh.device
    _check_device(mesh, scene.device, "the scene")
    camera = camera.to(dev)
    if tile_offset is None:
        tile_offset = torch.zeros(2, dtype=torch.float32, device=dev)
    tile_offset = torch.as_tensor(tile_offset, dtype=torch.float32, device=dev)
    if isinstance(path_id_base, torch.Tensor):
        path_id_base = path_id_base.to(dev)
    w, h = tile_dim
    n_pix = w * h

    def render_one(spp_n, base):
        if kernel == "fast":
            return fast.render_tile(
                scene, camera, settings, tile_dim, tile_offset, resolution,
                spp_n, seed, base, lanes_per_pixel=lanes_per_pixel,
                two_level=two_level, **fast_kwargs,
            )
        if kernel == "streaming":
            return streaming.render_tile(
                scene, camera, settings, tile_dim, tile_offset, resolution,
                spp_n, seed, base, n_lanes=min(n_lanes, n_pix * spp_n),
            )
        return naive.render_tile(
            scene, camera, settings, tile_dim, tile_offset, resolution,
            spp_n, seed, base,
        )

    shape = (h, w, 3) if tile_offset.ndim == 1 else (
        tile_offset.shape[0], h, w, 3)
    img = torch.zeros(shape, dtype=torch.float32, device=dev)
    n_rays = torch.zeros((), dtype=torch.float32, device=dev)
    if spp_shard > 0:
        img, n_rays = render_one(
            spp_shard, shard_base(path_id_base, mesh.rank, n_pix * spp_shard))
    if spp_rem > 0 and mesh.rank == 0:
        img_r, rays_r = render_one(
            spp_rem, shard_base(path_id_base, n, n_pix * spp_shard))
        img = img + img_r
        n_rays = n_rays + rays_r
    dist.all_reduce(img, group=mesh.group)
    dist.all_reduce(n_rays, group=mesh.group)
    return img, n_rays


def make_inverse_step(
    scene_spec,
    camera_spec,
    settings: RenderSettings,
    resolution: Tuple[int, int],
    spp_per_device: int,
    mesh: Mesh,
    optimizer: Callable[[Sequence[torch.Tensor]], torch.optim.Optimizer],
    two_level: bool = False,
):
    """The sharded inverse-rendering step.

    Per rank: render_diff with the rank's own sample streams (the seed
    salted as seed + rank * 0x9E3779B9, mod 2^32), the MSE of the
    spp-normalised image to the target, and backward; then the loss and
    both gradient grids are averaged over the ranks (all_reduce, then /N)
    and the optimizer steps.  `optimizer` is a factory: called once, on
    the first step, with the two leaf tensors (density, albedo) it
    returns the torch.optim optimizer that keeps their state, e.g.
    `lambda p: torch.optim.SGD(p, lr=5.0)` (JAX takes an optax
    optimizer and threads its state through the step).  The parameters
    are updated in place.

    Returns step(params, target, seed) -> (params, loss): params is the
    (density, albedo) pair of leaf tensors with requires_grad on the
    mesh's device (the same pair at every call), loss the rank-averaged
    loss before the update."""
    n = mesh.world_size
    held = {}

    def step(params, target, seed):
        density, albedo = params
        _check_device(mesh, density.device, "the density grid")
        if not held:
            held["params"] = (density, albedo)
            held["opt"] = optimizer([density, albedo])
        elif held["params"][0] is not density or held["params"][1] is not albedo:
            raise ValueError("step takes the parameters its optimizer holds")
        opt = held["opt"]
        opt.zero_grad(set_to_none=False)
        img = render_diff(
            density, albedo, device_seed(seed, mesh.rank), scene_spec,
            camera_spec, settings, resolution, spp_per_device, two_level,
        ) / float(spp_per_device)
        loss = torch.mean((img - target) ** 2)
        loss.backward()
        loss = loss.detach()
        for t in (loss, density.grad, albedo.grad):
            dist.all_reduce(t, group=mesh.group)
            t.div_(n)
        opt.step()
        return params, loss

    return step
