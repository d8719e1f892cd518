"""fastSK's multi-tile lane mode and the renderer's all-tiles dispatch.

A (T, 2) tile_offset with a (T,) path_id_base renders T tiles in one
cascade.  It is held against JAX's multi-tile call (n_rays exact, images
to 1e-4; on the null boundary, where the two packages take the same
branches: with the GGX boundary XLA's last bits move ~1e-4 of a
direction near grazing, ROADMAP C, and the test asks for most pixels),
against the port's own sequential tile loop bit for bit, and through
ProgressiveTiledRenderer as tests/test_renderer.py holds JAX's batched
dispatch."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cudavolumerenderer_tpu.models import fast as jfast
from cudavolumerenderer_tpu.ops import camera as jcam
from cudavolumerenderer_tpu.scene import types as jtypes
from cudavolumerenderer_tpu_torch import convert
from cudavolumerenderer_tpu_torch.config import Config, Kernel
from cudavolumerenderer_tpu_torch.models import fast
from cudavolumerenderer_tpu_torch.models.renderer import create_renderer
from cudavolumerenderer_tpu_torch.ops.camera import make_camera
from cudavolumerenderer_tpu_torch.scene import procedural
from cudavolumerenderer_tpu_torch.scene.types import (
    RenderSettings,
    make_medium,
    make_scene,
)

torch.set_num_threads(2)

RES, TILE, SPP = 32, 8, 2  # 4x4 tiles of 8x8
TILES = [(TILE * (i % 4), TILE * (i // 4)) for i in range(16)]
BASES = np.arange(16, dtype=np.uint32) * TILE * TILE * SPP + 3


def scenes():
    d = procedural.blob_volume((16, 16, 16), n_blobs=3)
    js = jtypes.make_scene(jtypes.make_medium(d, 0.8, scale=20.0,
                                              max_density=1.0))
    m = js.medium
    ts = convert.scene_from_arrays(
        m.density.data, m.albedo.data, m.albedo_affine, m.box_min,
        m.box_max, m.scale, m.max_density, m.g, js.bsdf.roughness,
        js.bsdf.eta, js.le,
    )
    jc = jcam.make_camera(RES, RES)
    return ts, convert.camera_from_arrays(jc.inv_view, jc.raster_to_view), js, jc


def multi_port(ts, tc, settings, **kw):
    return fast.render_tile(
        ts, tc, settings, (TILE, TILE), torch.tensor(TILES, dtype=torch.float32),
        (RES, RES), SPP, 1234, torch.tensor(BASES.astype(np.int64)), **kw,
    )


@pytest.mark.parametrize("bsdf", ["null", "ggx"])
@pytest.mark.parametrize("two_level", [False, True])
def test_multi_tile_equals_jax_multi_tile(bsdf, two_level):
    ts, tc, js, jc = scenes()
    img, n_rays = multi_port(ts, tc, RenderSettings.from_flags(True, bsdf_kind=bsdf),
                             two_level=two_level)
    jimg, jn_rays = jfast.render_tile(
        js, jc, jtypes.RenderSettings.from_flags(True, bsdf_kind=bsdf),
        (TILE, TILE), jnp.asarray(TILES, jnp.float32), (RES, RES), SPP, 1234,
        jnp.asarray(BASES), two_level=two_level,
    )
    a, b = img.numpy(), np.asarray(jimg)
    assert a.shape == b.shape == (16, TILE, TILE, 3)
    share = float(np.mean(np.all(np.abs(a - b) <= 1e-4, axis=-1)))
    print(f"{bsdf}: rays {float(n_rays)} vs {float(jn_rays)}; pixels within "
          f"1e-4: {share:.4f}")
    if bsdf == "null":
        assert float(n_rays) == float(jn_rays)
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-4)
    else:
        assert abs(float(n_rays) - float(jn_rays)) <= 0.01 * float(jn_rays)
        assert share > 0.9


@pytest.mark.parametrize("kw", [
    dict(two_level=False), dict(two_level=True),
    dict(two_level=True, lanes_per_pixel=2, min_width=256),
])
def test_multi_tile_equals_sequential_tiles(kw):
    ts, tc, _, _ = scenes()
    settings = RenderSettings.from_flags(True)
    img, n_rays = multi_port(ts, tc, settings, **kw)
    n_seq = 0.0
    for t, (ox, oy) in enumerate(TILES):
        tile, nr = fast.render_tile(
            ts, tc, settings, (TILE, TILE), torch.tensor([float(ox), float(oy)]),
            (RES, RES), SPP, 1234, int(BASES[t]), **kw,
        )
        assert torch.equal(img[t], tile), t
        n_seq += float(nr)
    assert float(n_rays) == n_seq


def test_multi_tile_keeps_the_tail_kernel_off():
    """The tail kernel's service loop is single-tile: with tail_pallas the
    multi-tile call renders as without it."""
    ts, tc, _, _ = scenes()
    settings = RenderSettings.from_flags(True)
    a = multi_port(ts, tc, settings, two_level=True, tail_pallas=True,
                   tail_pk_width=16)
    b = multi_port(ts, tc, settings, two_level=True)
    assert torch.equal(a[0], b[0]) and float(a[1]) == float(b[1])


def renderer_scene():
    d = procedural.blob_volume((16, 16, 16), n_blobs=3)
    return make_scene(make_medium(d, 0.8, scale=20.0, max_density=1.0,
                                  device="cpu"))


class Cascades:
    """Counts fast.render_tile calls while entered."""

    def __enter__(self):
        self.orig, self.offsets = fast.render_tile, []

        def counted(*args, **kw):
            self.offsets.append(tuple(args[4].shape))
            return self.orig(*args, **kw)

        fast.render_tile = counted
        return self

    def __exit__(self, *exc):
        fast.render_tile = self.orig


def render_sequential(scene, camera, config):
    r = create_renderer(scene, camera, config)
    r.init_rendering()
    while not r.image_complete():
        r.run_iterations(spp=r._spp_per_launch())
    return r.get_image(), r.n_rays


@pytest.mark.parametrize("kernel", [Kernel.FAST_SK, Kernel.STREAMING_SK,
                                    Kernel.NAIVE_SK])
@pytest.mark.parametrize("tiles,res", [((2, 2), 16), ((3, 2), 20)])
def test_batched_tiles_equal_sequential(kernel, tiles, res):
    scene, camera = renderer_scene(), make_camera(res, res, device="cpu")
    cfg = dict(kernel=kernel, iterations=4, resolution=(res, res),
               n_tiles=tiles, n_lanes=256,
               settings=RenderSettings.from_flags(True))
    img_seq, nr_seq = render_sequential(scene, camera, Config(**cfg))
    r = create_renderer(scene, camera, Config(**cfg))
    with Cascades() as cascades:
        img_bat = r.render()
    assert r.image_complete()
    np.testing.assert_array_equal(img_bat, img_seq)
    assert r.n_rays == nr_seq
    if kernel == Kernel.FAST_SK:  # one cascade over every tile
        assert cascades.offsets == [(tiles[0] * tiles[1], 2)]


def test_ragged_tiles_cover_image():
    """20x20 image with 3x3 ceil-division tiles (7x7 tile dim, one-pixel
    overhang per edge): every pixel rendered exactly once."""
    res = 20
    cfg = Config(kernel=Kernel.FAST_SK, iterations=2, resolution=(res, res),
                 n_tiles=(3, 3),
                 settings=RenderSettings.from_flags(True, russian_roulette=False))
    img = create_renderer(renderer_scene(),
                          make_camera(res, res, device="cpu"), cfg).render()
    assert img.shape == (res, res, 3)
    assert np.isfinite(img).all()
    # RR off + constant environment: every path escapes with positive
    # throughput, so no pixel can stay black
    assert (img > 0).all()


def test_progressive_pass_batched_equals_sequential():
    """run_pass(spp) (one cascade over all tiles) matches looping
    run_iterations(spp) over every tile bit for bit, across passes."""
    scene, camera = renderer_scene(), make_camera(16, 16, device="cpu")
    cfg = dict(kernel=Kernel.FAST_SK, iterations=4, resolution=(16, 16),
               n_tiles=(2, 2), n_lanes=256,
               settings=RenderSettings.from_flags(True))
    r_seq = create_renderer(scene, camera, Config(**cfg))
    r_bat = create_renderer(scene, camera, Config(**cfg))
    for _ in range(2):  # two progressive passes of 2 spp each
        for _ in range(len(r_seq.tiles)):
            r_seq.run_iterations(spp=2)
        with Cascades() as cascades:
            r_bat.run_pass(2)
        assert len(cascades.offsets) == 1
        np.testing.assert_array_equal(r_bat.accum, r_seq.accum)
        assert r_bat.path_id_base == r_seq.path_id_base
    assert r_bat.image_complete() and r_seq.image_complete()
    r_bat.run_pass(1)  # a further pass is a no-op once complete
    np.testing.assert_array_equal(r_bat.accum, r_seq.accum)


def test_run_pass_uneven_progress_respects_iteration_cap():
    """Mixing run_iterations with run_pass never renders a tile past
    config.iterations: uneven progress takes the sequential loop."""
    scene, camera = renderer_scene(), make_camera(16, 16, device="cpu")
    cfg = dict(kernel=Kernel.FAST_SK, iterations=2, resolution=(16, 16),
               n_tiles=(2, 2), n_lanes=256,
               settings=RenderSettings.from_flags(True))
    r = create_renderer(scene, camera, Config(**cfg))
    r.run_iterations(spp=2)  # tile 0 done up front -> uneven progress
    assert list(r.iterations_done) == [2, 0, 0, 0]
    r.run_pass(2)
    assert list(r.iterations_done) == [2, 2, 2, 2]
    assert r.image_complete()
    r2 = create_renderer(scene, camera, Config(**cfg))
    r2.run_pass(2)
    np.testing.assert_array_equal(r.accum, r2.accum)


def test_render_device_matches_render():
    """render_device + get_image equals render(): the benchmark protocol
    fences on the ray counter and copies the image after the timed
    region."""
    scene, camera = renderer_scene(), make_camera(16, 16, device="cpu")
    cfg = dict(kernel=Kernel.FAST_SK, iterations=3, resolution=(16, 16),
               n_tiles=(2, 2), two_level=True,
               settings=RenderSettings.from_flags(True))
    r1 = create_renderer(scene, camera, Config(**cfg))
    img1 = r1.render()
    r2 = create_renderer(scene, camera, Config(**cfg))
    r2.render_device()
    nr2 = r2.n_rays  # the protocol's fence
    np.testing.assert_array_equal(img1, r2.get_image())
    assert nr2 == r1.n_rays


def test_multi_mode_gate():
    """Multi-tile mode engages for fastSK with several tiles of at most
    MULTI_TILE_LANES lanes; larger tiles keep the sequential loop."""
    from cudavolumerenderer_tpu_torch.models import renderer as rmod

    scene = renderer_scene()

    def uses(**kw):
        cfg = Config(**{"kernel": Kernel.FAST_SK, "iterations": 1, **kw})
        return create_renderer(scene, make_camera(8, 8, device="cpu"),
                               cfg)._use_multi()

    assert uses(resolution=(80, 80), n_tiles=(2, 2))
    assert not uses(resolution=(80, 80), n_tiles=(1, 1))
    assert not uses(resolution=(80, 80), n_tiles=(2, 2), lanes_per_pixel=2)
    assert not uses(resolution=(96, 96), n_tiles=(2, 2))  # 48^2 > 2048
    assert not uses(resolution=(80, 80), n_tiles=(2, 2),
                    kernel=Kernel.STREAMING_SK)
    assert rmod.MULTI_TILE_LANES == 2048 and rmod.MAX_BATCH_LANES == 1 << 22
