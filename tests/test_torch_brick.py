"""brickSK on the CPU: the port's brick.render_tile (the tracking kernel's
plain version on CPU tensors) against the JAX package's
brick.render_tile with the Pallas kernel in interpret mode, on the same
converted smoke scene (n_rays exactly, pixels to 1e-4); the exact white
furnace; create_renderer's
brickSK against render_tile; and the errors brickSK raises."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cudavolumerenderer_tpu.models import brick as jbrick
from cudavolumerenderer_tpu.ops import camera as jcam
from cudavolumerenderer_tpu.scene import types as jtypes
from cudavolumerenderer_tpu_torch import convert
from cudavolumerenderer_tpu_torch.config import Config, Kernel
from cudavolumerenderer_tpu_torch.models import brick as tbrick
from cudavolumerenderer_tpu_torch.models.renderer import (
    create_renderer,
    make_kernel_fn,
)
from cudavolumerenderer_tpu_torch.ops import camera as tcam
from cudavolumerenderer_tpu_torch.scene import procedural
from cudavolumerenderer_tpu_torch.scene import types as ttypes

torch.set_num_threads(2)

#: images agree with JAX to XLA's transcendentals (tests/test_torch_schedulers.py)
JAX_TOL = dict(rtol=1e-4, atol=1e-4)


def smoke_scenes(scale):
    """smoke_volume((32, 32, 16)) with albedo 0.9 d (affine in density),
    built by JAX and carried across with convert."""
    d = procedural.smoke_volume((32, 32, 16))
    alb = np.stack([d, d, d], axis=-1) * 0.9
    js = jtypes.make_scene(
        jtypes.make_medium(d, alb, scale=scale, max_density=float(d.max()))
    )
    m = js.medium
    ts = convert.scene_from_arrays(
        m.density.data, m.albedo.data, m.albedo_affine, m.box_min,
        m.box_max, m.scale, m.max_density, m.g, js.bsdf.roughness,
        js.bsdf.eta, js.le,
    )
    return ts, js


@pytest.mark.parametrize("scale", [800.0, 100.0])
def test_render_tile_agrees_with_jax(scale):
    ts, js = smoke_scenes(scale)
    res, spp, seed = 16, 2, 5
    jc = jcam.make_camera(res, res)
    tc = convert.camera_from_arrays(jc.inv_view, jc.raster_to_view)
    t_img, t_rays, rounds = tbrick.render_tile(
        ts, tc, ttypes.RenderSettings.from_flags(True), (res, res),
        torch.zeros(2), (res, res), spp, seed, 0, with_stats=True,
    )
    j_img, j_rays = jbrick.render_tile(
        js, jc, jtypes.RenderSettings.from_flags(True), (res, res),
        jnp.zeros(2, jnp.float32), (res, res), spp, seed, 0, interpret=True,
    )
    a, b = t_img.numpy() / spp, np.asarray(j_img) / spp
    t_rays, j_rays = float(t_rays), float(j_rays)
    share = float(np.mean(np.abs(a - b) < 1e-4))
    print(f"scale {scale}: {rounds} rounds; rays {t_rays} vs {j_rays}; "
          f"means {a.mean():.6f} vs {b.mean():.6f}; pixels equal within "
          f"1e-4: {share:.3f}")
    assert np.isfinite(a).all() and a.shape == (res, res, 3)
    # the same paths: every ray counted, every pixel to XLA's last bits
    assert t_rays == j_rays
    np.testing.assert_allclose(a, b, **JAX_TOL)
    assert rounds > 0


def test_white_furnace_exact():
    """albedo 1 + null boundary + no roulette: every path ends by leaving
    the box with throughput 1, so every pixel is exactly spp."""
    d = procedural.blob_volume((24, 24, 24), n_blobs=3)
    scene = ttypes.make_scene(ttypes.make_medium(
        d, 1.0, scale=8.0, max_density=1.0, device="cpu"))
    settings = ttypes.RenderSettings.from_flags(
        True, russian_roulette=False, bsdf_kind="null"
    )
    spp = 2
    img, n_rays, rounds = tbrick.render_tile(
        scene, tcam.make_camera(16, 16, device="cpu"), settings, (16, 16),
        torch.zeros(2),
        (16, 16), spp, 3, 0, with_stats=True,
    )
    assert rounds > 1 and float(n_rays) > 16 * 16 * spp
    np.testing.assert_array_equal(img.numpy(), float(spp))


def test_create_renderer_equals_render_tile():
    scene, _ = smoke_scenes(100.0)
    camera = tcam.make_camera(16, 8, device="cpu")
    cfg = Config(kernel=Kernel.BRICK_SK, resolution=(16, 8), iterations=3,
                 seed=9)
    renderer = create_renderer(scene, camera, cfg)
    img = renderer.render()
    tile, n_rays = make_kernel_fn(cfg)(
        scene, camera, cfg.settings, (16, 8), torch.zeros(2), (16, 8),
        cfg.iterations, cfg.seed, 0,
    )
    assert img.shape == (8, 16, 3) and np.isfinite(img).all()
    np.testing.assert_array_equal(img, tile.numpy() / cfg.iterations)
    assert renderer.n_rays == float(n_rays) > 0


def test_lane_count_must_divide_into_rows():
    scene, _ = smoke_scenes(100.0)
    with pytest.raises(ValueError, match="divisible by 128"):
        tbrick.render_tile(
            scene, tcam.make_camera(10, 10, device="cpu"),
            ttypes.RenderSettings(),
            (10, 10), torch.zeros(2), (10, 10), 1, 0, 0,
        )


@pytest.mark.parametrize(
    "kernel", [Kernel.BRICK_SK, Kernel.FAST_SK, Kernel.FAST_Q]
)
def test_variable_boundary_is_refused(kernel):
    settings = ttypes.RenderSettings.from_flags(True, boundary="variable")
    with pytest.raises(ValueError, match="AABB boundary"):
        make_kernel_fn(Config(kernel=kernel, settings=settings))
