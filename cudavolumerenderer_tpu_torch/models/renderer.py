"""Progressive tiled renderer + factory.

Port of cudavolumerenderer_tpu/models/renderer.py (reference:
CudaVolPath.cpp:13-347, RendererFactory.h:13-155): builds the row-major
tile array, advances one tile per run_iterations call, accumulates raw
radiance sums on the scene's device, and exposes get_image with the
1/iterations display scale.  fastSK renders every tile of a pass in one
cascade (multi-tile lane mode, fast.render_tile with (T, 2) offsets) when
its tiles are small; every other case renders the tiles one after
another.  Both give the same image bit for bit.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from ..config import Config, Kernel
from ..ops.camera import Camera
from ..scene.types import Scene
from ..utils import occupancy
from . import brick, fast, fastq, naive, regeneration, streaming, wavefront_mk

#: multi-tile lane mode engages for fastSK tiles of at most this many
#: lanes (the JAX package's measured crossover, models/renderer.py:288-294)
MULTI_TILE_LANES = 2048
#: and at most this many lanes over all tiles
MAX_BATCH_LANES = 1 << 22


def _tile_array(
    n_tiles: Tuple[int, int], tile_dim: Tuple[int, int]
) -> List[Tuple[int, int]]:
    """Row-major tile origins (reference: initTileArray,
    CudaVolPath.cpp:13-29)."""
    return [
        (tile_dim[0] * (i % n_tiles[0]), tile_dim[1] * (i // n_tiles[0]))
        for i in range(n_tiles[0] * n_tiles[1])
    ]


class ProgressiveTiledRenderer:
    """The single algorithm (reference: CudaVolPath) over a scheduler.

    Progressive contract (reference: AbstractRenderer.h:14-24):
    init_rendering → {run_iterations; get_image}* until image_complete.
    The scene's device is the render's device; the camera is moved there.
    """

    def __init__(self, scene: Scene, camera: Camera, config: Config):
        self.scene = scene
        self.device = scene.device
        self.camera = camera.to(self.device)
        self.config = config
        self.settings = config.settings
        tiling = config.tiling
        self.tile_dim = tiling.tile_dim
        self.tiles = _tile_array(config.n_tiles, self.tile_dim)
        grid_shape = tuple(scene.medium.density.data.shape)
        if config.n_lanes is None:
            config.n_lanes = occupancy.pick_n_lanes(
                self.tile_dim[0] * self.tile_dim[1],
                config.iterations, grid_shape, device=self.device,
            )
        else:
            occupancy.validate_pool(
                config.n_lanes, grid_shape, device=self.device
            )
        self.kernel_fn = make_kernel_fn(config)
        self.init_rendering()

    # -- progressive interface -------------------------------------------
    def init_rendering(self) -> None:
        w, h = self.config.resolution
        self._accum_dev = torch.zeros(
            (h, w, 3), dtype=torch.float32, device=self.device
        )
        self._n_rays_dev = torch.zeros((), dtype=torch.float32, device=self.device)
        self.iterations_done = np.zeros(len(self.tiles), np.int64)
        self.current_tile = 0
        self.path_id_base = 0

    @property
    def accum(self) -> np.ndarray:
        return self._accum_dev.cpu().numpy()

    @property
    def n_rays(self) -> float:
        return float(self._n_rays_dev)

    def image_complete(self) -> bool:
        return bool(np.all(self.iterations_done >= self.config.iterations))

    def run_iterations(self, spp: Optional[int] = None) -> None:
        """Render one tile's next batch of iterations
        (reference: CudaVolPath::runIterations, CudaVolPath.cpp:249-280)."""
        cfg = self.config
        idx = self.current_tile
        remaining = cfg.iterations - int(self.iterations_done[idx])
        if remaining <= 0:
            self.current_tile = (idx + 1) % len(self.tiles)
            return
        spp = min(spp or cfg.iterations, remaining)

        ox, oy = self.tiles[idx]
        tw, th = self.tile_dim
        w, hres = cfg.resolution
        # clip tile to image (ceil-division tiles may overhang)
        cw, ch = min(tw, w - ox), min(th, hres - oy)

        tile_img, n_rays = self.kernel_fn(
            self.scene, self.camera, self.settings, (tw, th),
            torch.tensor([float(ox), float(oy)], device=self.device),
            (w, hres), spp, cfg.seed, self.path_id_base,
        )
        self.path_id_base += tw * th * spp
        self._n_rays_dev = self._n_rays_dev + n_rays
        self._accum_dev[oy:oy + ch, ox:ox + cw] += tile_img[:ch, :cw]
        self.iterations_done[idx] += spp
        self.current_tile = (idx + 1) % len(self.tiles)

    def run_pass(self, spp: int = 1) -> None:
        """One progressive pass over all tiles, starting at tile 0 (the
        row-major path-id order).  With uniform progress and small fastSK
        tiles the pass is one cascade over all tiles; with uneven
        per-tile progress each tile clamps to its own remaining
        iterations in the sequential loop.  Bit for bit the same as
        looping run_iterations(spp) over every tile."""
        self.current_tile = 0
        spp = min(spp, self.config.iterations - int(self.iterations_done.min()))
        if spp <= 0:
            return
        uniform = int(self.iterations_done.min()) == int(self.iterations_done.max())
        if uniform and self._use_multi():
            self._render_all_tiles_batched(spp)
            return
        for _ in range(len(self.tiles)):
            self.run_iterations(spp=spp)

    def get_image(self) -> np.ndarray:
        """Accumulated radiance scaled by 1/iterations-done (reference:
        getImage + UtilityFunctors::Scale); copies the image to the host."""
        done = max(int(self.iterations_done.min()), 1)
        return self.accum / float(done)

    # -- batch mode -------------------------------------------------------
    def render(
        self, progress_callback: Optional[Callable[[float], None]] = None
    ) -> np.ndarray:
        """Full batch render, image copied to the host (reference:
        CudaVolPath::render, CudaVolPath.cpp:339-347)."""
        self.render_device(progress_callback)
        return self.get_image()

    def render_device(self, progress_callback=None) -> None:
        """render() minus the final host image copy: all work issued,
        image left on the device (read it with get_image)."""
        self.init_rendering()
        if self._use_multi():
            self._render_all_tiles_batched(self.config.iterations)
            return
        total = len(self.tiles) * self.config.iterations
        while not self.image_complete():
            self.run_iterations(spp=self._spp_per_launch())
            if progress_callback is not None:
                progress_callback(float(self.iterations_done.sum()) / total)

    def _use_multi(self) -> bool:
        """fastSK renders all tiles in one cascade when there are several
        and each is small (JAX models/renderer.py:288-294): then a tile
        no longer pays a whole cascade drain.  Larger tiles keep the
        sequential loop, which the JAX package measured faster there.
        The other kernels keep the sequential loop (JAX's lax.map over
        tiles is sequential too), so JAX's per-tile lane cap for naiveSK
        (_batch_lanes_ok) has nothing to gate here."""
        tw, th = self.tile_dim
        lanes = tw * th * max(1, self.config.lanes_per_pixel)
        return (
            self.config.kernel == Kernel.FAST_SK
            and len(self.tiles) > 1
            and lanes <= MULTI_TILE_LANES
            and len(self.tiles) * lanes <= MAX_BATCH_LANES
        )

    def _render_all_tiles_batched(self, spp: int) -> None:
        """Every tile in one fastSK cascade (JAX _render_all_tiles_batched):
        tile t takes path ids from path_id_base + t * tw * th * spp, as
        the sequential loop gives them, and the (T, th, tw, 3) tiles are
        assembled row-major into the image on the device."""
        cfg = self.config
        tw, th = self.tile_dim
        w, hres = cfg.resolution
        ntx, nty = cfg.n_tiles
        n_tiles = len(self.tiles)
        offsets = torch.tensor(self.tiles, dtype=torch.float32, device=self.device)
        bases = self.path_id_base + torch.arange(
            n_tiles, dtype=torch.int64, device=self.device
        ) * (tw * th * spp)
        imgs, n_rays = self.kernel_fn(
            self.scene, self.camera, self.settings, (tw, th), offsets,
            (w, hres), spp, cfg.seed, bases,
        )
        padded = (
            imgs.reshape(nty, ntx, th, tw, 3)
            .permute(0, 2, 1, 3, 4)
            .reshape(nty * th, ntx * tw, 3)
        )
        self._accum_dev = self._accum_dev + padded[:hres, :w]
        self._n_rays_dev = self._n_rays_dev + n_rays
        self.path_id_base += n_tiles * tw * th * spp
        self.iterations_done += spp

    def _spp_per_launch(self) -> int:
        if self.config.kernel in (Kernel.NAIVE_SK, Kernel.NAIVE_MK):
            # bound lane memory: pixels x spp lanes are held at once
            return max(1, min(self.config.spp_per_launch,
                              self.config.iterations))
        return self.config.iterations


def fast_keywords(config: Config) -> dict:
    """The keywords make_kernel_fn passes fast.render_tile for fastSK."""
    return dict(
        two_level=config.two_level,
        lanes_per_pixel=config.lanes_per_pixel,
        defer_ggx=config.defer_ggx,
        brick_major=config.brick_major,
        cascade_factor=config.cascade_factor,
        tail_single_level=config.tail_single_level,
        tail_spec=config.tail_spec,
        spec_width=config.spec_width,
        min_width=config.min_width,
        tail_bricks=config.tail_bricks,
        tail_pallas=config.tail_pallas,
        tail_pk_width=config.tail_pk_width,
        tail_pk_steps=config.tail_pk_steps,
        table_bits=config.effective_table_bits,
        **({"max_bricks": config.max_bricks}
           if config.max_bricks is not None else {}),
    )


def make_kernel_fn(config: Config):
    """Scheduler dispatch (reference: RendererFactory::createRenderer's
    kernel matrix, RendererFactory.h:43-113), row for row the JAX
    package's.  The integrator family's functions take render_tile's
    keywords beside, as does fastQ's (eager_body=True runs the eager bodies
    on the card)."""
    k = config.kernel
    if (
        config.settings.boundary == "variable"
        and k in (Kernel.FAST_SK, Kernel.FAST_Q, Kernel.BRICK_SK)
    ):
        raise ValueError(
            "--boundary variable is supported by the integrator-family "
            "schedulers (naiveSK/naiveMK/regenerationSK/streamingSK/"
            "streamingMK/sortingSK); fastSK/fastQ/brickSK fused tables "
            "keep the AABB boundary"
        )
    if k == Kernel.FAST_SK:
        def fsk(*args):
            return fast.render_tile(*args, **fast_keywords(config))
        return fsk
    if k == Kernel.BRICK_SK:
        return brick.render_tile
    if k == Kernel.FAST_Q:
        def fq(*args, **kw):
            return fastq.render_tile(
                *args, n_lanes=config.n_lanes, two_level=config.two_level,
                **kw
            )
        return fq
    if k == Kernel.NAIVE_SK:
        return naive.render_tile
    if k == Kernel.NAIVE_MK:
        return wavefront_mk.render_tile
    if k == Kernel.REGENERATION_SK:
        group = regeneration.LEVEL_GROUPS[config.regeneration_level]

        def regen(*args, **kw):
            return regeneration.render_tile(
                *args, n_lanes=config.n_lanes, refill_group=group, **kw
            )
        return regen
    if k == Kernel.STREAMING_SK:
        def stream(*args, **kw):
            return streaming.render_tile(*args, n_lanes=config.n_lanes, **kw)
        return stream
    if k == Kernel.SORTING_SK:
        def sort(*args, **kw):
            # Morton reorder + deferred coherent albedo access, the two
            # halves of the reference strategy
            # (SortingVolPTsk_kernel.cuh:105-176)
            return streaming.render_tile(
                *args, n_lanes=config.n_lanes, sort_every=8,
                defer_access=True, **kw
            )
        return sort
    if k == Kernel.STREAMING_MK:
        def stream_mk(*args, **kw):
            # host-looped regenerate/extend/compact super-iterations with
            # a device→host active-count read per dispatch (reference:
            # RenderKernelLauncher.cu:435-472)
            return wavefront_mk.render_tile_streaming_mk(
                *args, n_lanes=max(1024, config.n_lanes // 8), **kw
            )
        return stream_mk
    raise ValueError(f"unhandled kernel {k}")


def create_renderer(
    scene: Scene, camera: Camera, config: Config
) -> ProgressiveTiledRenderer:
    return ProgressiveTiledRenderer(scene, camera, config)
