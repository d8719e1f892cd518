"""The whole slice on the CPU: the port's fastSK two-level render with the
tail kernel stage (its plain version on CPU tensors) against the JAX
package's render with the Pallas tail kernel in interpret mode, on the
same converted scene; the exact white furnace; and create_renderer's
progressive renderer against render_tile."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cudavolumerenderer_tpu.models import fast as jfast
from cudavolumerenderer_tpu.ops import camera as jcam
from cudavolumerenderer_tpu.scene import types as jtypes
from cudavolumerenderer_tpu_torch import convert
from cudavolumerenderer_tpu_torch.config import Config, Kernel
from cudavolumerenderer_tpu_torch.models import fast as tfast
from cudavolumerenderer_tpu_torch.models.renderer import (
    create_renderer,
    make_kernel_fn,
)
from cudavolumerenderer_tpu_torch.ops import camera as tcam
from cudavolumerenderer_tpu_torch.scene import procedural
from cudavolumerenderer_tpu_torch.scene import types as ttypes
from cudavolumerenderer_tpu_torch.scene.loader import load_scene

torch.set_num_threads(2)

TAIL = dict(two_level=True, tail_pallas=True, tail_pk_width=16,
            tail_pk_steps=8, min_width=32)


def medical_scenes(n=24, scale=30.0):
    """A small medical_volume with the MHD red-channel albedo (affine in
    density), built by JAX and carried across with convert."""
    d = procedural.medical_volume((n, n, n), n_blobs=6)
    albedo = np.zeros(d.shape + (3,), np.float32)
    albedo[..., 0] = d
    js = jtypes.make_scene(jtypes.make_medium(d, albedo, scale=scale,
                                              max_density=1.0))
    m = js.medium
    ts = convert.scene_from_arrays(
        m.density.data, m.albedo.data, m.albedo_affine, m.box_min,
        m.box_max, m.scale, m.max_density, m.g, js.bsdf.roughness,
        js.bsdf.eta, js.le,
    )
    return ts, js


def cameras(res):
    jc = jcam.make_camera(res, res)
    return convert.camera_from_arrays(jc.inv_view, jc.raster_to_view), jc


def test_slice_agrees_with_jax_tail_kernel():
    ts, js = medical_scenes()
    res, spp, seed = 8, 32, 5
    tc, jc = cameras(res)
    flags = dict(russian_roulette=True, max_path_length=64)
    t_img, t_rays, _, _, t_rows = tfast.render_tile(
        ts, tc, ttypes.RenderSettings.from_flags(True, **flags), (res, res),
        torch.zeros(2), (res, res), spp, seed, 0, with_stats=True, **TAIL,
    )
    j_img, j_rays, _, _, j_rows = jfast.render_tile(
        js, jc, jtypes.RenderSettings.from_flags(True, **flags), (res, res),
        jnp.zeros(2, jnp.float32), (res, res), spp, seed, 0,
        with_stats=True, tail_pk_interpret=True, **TAIL,
    )
    # the tail kernel stage ran in both
    assert float(t_rows[-1]) > 0 and float(j_rows[-1]) > 0
    t_rays, j_rays = float(t_rays), float(j_rays)
    assert abs(t_rays - j_rays) / j_rays < 0.1
    a, b = t_img.numpy() / spp, np.asarray(j_img) / spp
    assert np.isfinite(a).all()
    # bounds of tests/test_tailpk.py's statistical agreement test
    assert abs(a.mean() - b.mean()) < 0.02, (a.mean(), b.mean())
    assert np.abs(a - b).max() < 0.25
    share = float(np.mean(np.abs(a - b) < 1e-4))
    print(f"pixels equal within 1e-4: {share:.3f}; rays {t_rays} vs {j_rays}")
    # same streams: most pixels are the same to float rounding
    assert share > 0.5


def test_single_level_agrees_with_jax():
    ts, js = medical_scenes(n=16, scale=20.0)
    res, spp = 6, 8
    tc, jc = cameras(res)
    t_img, t_rays = tfast.render_tile(
        ts, tc, ttypes.RenderSettings.from_flags(True), (res, res),
        torch.zeros(2), (res, res), spp, 3, 0,
    )
    j_img, j_rays = jfast.render_tile(
        js, jc, jtypes.RenderSettings.from_flags(True), (res, res),
        jnp.zeros(2, jnp.float32), (res, res), spp, 3, 0,
    )
    a, b = t_img.numpy() / spp, np.asarray(j_img) / spp
    assert abs(a.mean() - b.mean()) < 0.02
    assert abs(float(t_rays) - float(j_rays)) / float(j_rays) < 0.1


def test_white_furnace_exact_through_tail_stage():
    """albedo=1 + null boundary => every pixel exactly spp: the kernel's
    scatters, the service loop's boundary events and regeneration all
    conserve energy."""
    d = procedural.blob_volume((24, 24, 24), n_blobs=3)
    scene = ttypes.make_scene(ttypes.make_medium(
        d, 1.0, scale=8.0, max_density=1.0, device="cpu"))
    settings = ttypes.RenderSettings.from_flags(
        True, russian_roulette=False, max_path_length=200, bsdf_kind="null",
    )
    spp = 2
    img, _, _, _, rows = tfast.render_tile(
        scene, tcam.make_camera(6, 6, device="cpu"), settings, (6, 6),
        torch.zeros(2),
        (6, 6), spp, 3, 0, with_stats=True, **TAIL,
    )
    assert float(rows[-1]) > 0
    np.testing.assert_allclose(img.numpy(), float(spp), rtol=2e-5)


def test_full_albedo_keeps_wavefront_tail():
    """A per-voxel (non-affine) albedo cannot use the kernel's A*rho+B:
    tail_pallas then renders exactly as without it."""
    d = procedural.blob_volume((12, 12, 12), n_blobs=2)
    albedo = np.random.RandomState(1).rand(12, 12, 12, 4).astype(np.float32)
    scene = ttypes.make_scene(ttypes.make_medium(
        d, albedo, scale=8.0, max_density=1.0, device="cpu"))
    args = (scene, tcam.make_camera(6, 6, device="cpu"),
            ttypes.RenderSettings(), (6, 6),
            torch.zeros(2), (6, 6), 2, 3, 0)
    a, _ = tfast.render_tile(*args, two_level=True, tail_pallas=True)
    b, _ = tfast.render_tile(*args, two_level=True)
    assert torch.equal(a, b)


def write_mhd(tmp_path, n=20):
    d = procedural.medical_volume((n, n, n), n_blobs=6)
    (d * 4095.0).astype("<u2").tofile(tmp_path / "vol.raw")
    path = tmp_path / "vol.mhd"
    path.write_text(
        "ObjectType = Image\nNDims = 3\nBinaryData = True\n"
        "BinaryDataByteOrderMSB = False\n"
        f"DimSize = {n} {n} {n}\nElementType = MET_USHORT\n"
        "ElementSpacing = 1 1 1\nElementDataFile = vol.raw\n"
    )
    return str(path)


def test_create_renderer_agrees_with_render_tile(tmp_path):
    cfg = Config(
        scene_file=write_mhd(tmp_path), kernel=Kernel.FAST_SK,
        two_level=True, tail_pallas=True, tail_pk_width=16, min_width=32,
        resolution=(8, 8), iterations=3, n_tiles=(1, 1), seed=7,
    )
    scene, camera = load_scene(cfg, device="cpu")
    assert tfast._albedo_mode(scene) == "affine"
    renderer = create_renderer(scene, camera, cfg)
    img = renderer.render()
    assert img.shape == (8, 8, 3) and np.isfinite(img).all()
    assert renderer.n_rays > 0
    tile, n_rays = make_kernel_fn(cfg)(
        scene, camera, cfg.settings, (8, 8), torch.zeros(2), (8, 8),
        cfg.iterations, cfg.seed, 0,
    )
    np.testing.assert_array_equal(img, tile.numpy() / cfg.iterations)
    assert renderer.n_rays == float(n_rays)


def test_tiled_progressive_passes_match_one_batch(tmp_path):
    """Two tiles rendered pass by pass give the batch render's image:
    per-tile path ids do not depend on how the iterations are split."""
    cfg = Config(scene_file=write_mhd(tmp_path, n=12), two_level=True,
                 resolution=(8, 6), iterations=2, n_tiles=(2, 1))
    scene, camera = load_scene(cfg, device="cpu")
    batch = create_renderer(scene, camera, cfg).render()
    renderer = create_renderer(scene, camera, cfg)
    while not renderer.image_complete():
        renderer.run_pass(spp=1)
    prog = renderer.get_image()
    assert np.isfinite(batch).all()
    assert abs(prog.mean() - batch.mean()) < 0.1


@pytest.mark.parametrize("option", [
    dict(defer_ggx=1), dict(defer_ggx=4), dict(brick_major=True),
    dict(tail_spec=2), dict(tail_single_level=True), dict(tail_bricks=4),
])
def test_unported_options_raise(option):
    """These options raised until they were ported; each now renders a
    finite image (tests/test_torch_fast_options.py holds them against
    JAX), and defer_ggx and brick_major (a layout; the 8^3 grid does not
    divide its bricks, so it stays row-major) equal the default render
    bit for bit."""
    scene, _ = medical_scenes(n=8)
    args = (scene, tcam.make_camera(16, 16, device="cpu"),
            ttypes.RenderSettings(), (16, 16), torch.zeros(2), (16, 16), 2,
            0, 0)
    # 512 lanes in pools of 512 and 256: the second is a tail pool
    kw = dict(two_level=True, lanes_per_pixel=2, min_width=256)
    img, n_rays = tfast.render_tile(*args, **kw, **option)
    assert torch.isfinite(img).all() and float(n_rays) > 0
    if "defer_ggx" in option or "brick_major" in option:
        ref, ref_rays = tfast.render_tile(*args, **kw)
        assert torch.equal(img, ref) and float(n_rays) == float(ref_rays)


def test_multi_tile_offsets_raise():
    """(T, 2) offsets render (multi-tile lane mode, tests/test_torch_tiles.py);
    combined with defer_ggx, which raised until it was ported, they render
    the same tiles bit for bit."""
    scene, _ = medical_scenes(n=8)
    args = (scene, tcam.make_camera(4, 4, device="cpu"),
            ttypes.RenderSettings(), (4, 4),
            torch.tensor([[0.0, 0.0], [4.0, 0.0], [0.0, 4.0]]), (8, 8), 1, 0,
            torch.tensor([0, 16, 32]))
    img, n_rays = tfast.render_tile(*args, defer_ggx=2)
    ref, ref_rays = tfast.render_tile(*args)
    assert img.shape == (3, 4, 4, 3) and torch.isfinite(img).all()
    assert torch.equal(img, ref) and float(n_rays) == float(ref_rays)


def test_other_kernels_and_scene_types_raise(tmp_path):
    # every scheduler is ported: make_kernel_fn returns a function for each
    for kernel in Kernel:
        assert callable(make_kernel_fn(Config(kernel=kernel))), kernel
    # every scene type loads (tests/test_torch_vdb.py); a file that is
    # not a scene of its type raises its reader's error
    for name, error, match in (("v.vdb", RuntimeError, "cvr_vdb"),
                               ("v.npz", ValueError, "pickled")):
        path = tmp_path / name
        path.write_bytes(bytes(8))
        with pytest.raises(error, match=match):
            load_scene(Config(scene_file=str(path)), device="cpu")
