"""Oracles and invariances of the port's integrator family, the analogs
of tests/test_integrator.py, tests/test_variable_boundary.py and the
naiveSK row of tests/test_oracle.py: the exact white furnace (through
every scheduler), background passthrough, determinism, sample-batching
invariance, the independent scalar oracle (tests/oracle.py, which
imports no JAX), and the variable-boundary march, also against JAX."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cudavolumerenderer_tpu.models import integrator as jint
from cudavolumerenderer_tpu.ops import aabb as jaabb
from cudavolumerenderer_tpu.ops import rng as jrng
from cudavolumerenderer_tpu.scene import types as jtypes
from cudavolumerenderer_tpu_torch import convert
from cudavolumerenderer_tpu_torch.config import Config, Kernel
from cudavolumerenderer_tpu_torch.models import integrator, naive
from cudavolumerenderer_tpu_torch.models.renderer import make_kernel_fn
from cudavolumerenderer_tpu_torch.ops import aabb, gradient
from cudavolumerenderer_tpu_torch.ops.camera import (
    make_camera,
    make_camera_look_at,
)
from cudavolumerenderer_tpu_torch.ops.grid import Grid
from cudavolumerenderer_tpu_torch.ops.rng import make_rng
from cudavolumerenderer_tpu_torch.scene import procedural
from cudavolumerenderer_tpu_torch.scene.types import (
    RenderSettings,
    make_medium,
    make_scene,
)

sys.path.insert(0, os.path.dirname(__file__))
import test_oracle  # noqa: E402
from oracle import render_oracle  # noqa: E402

torch.set_num_threads(2)


def small_scene(albedo_value=None, scale=40.0, g=0.0):
    dens = procedural.blob_volume()
    if albedo_value is None:
        albedo = np.stack([dens, 0.5 * np.ones_like(dens), 1.0 - dens], -1)
    else:
        albedo = np.full(dens.shape + (3,), albedo_value, np.float32)
    return make_scene(make_medium(dens, albedo, scale=scale, max_density=1.0,
                                  g=g, device="cpu"))


def render(scene, settings, res=32, spp=4, seed=1, base=0, fn=naive.render_tile):
    img, n_rays = fn(scene, make_camera(res, res, device="cpu"), settings,
                     (res, res),
                     torch.zeros(2), (res, res), spp, seed, base)
    return img.numpy() / spp, float(n_rays)


NULL = RenderSettings.from_flags(True, bsdf_kind="null")


# -- oracles ----------------------------------------------------------------------

def test_white_furnace():
    """Albedo 1 + pass-through boundary: every path leaves with
    throughput exactly 1, so every pixel is exactly 1."""
    img, _ = render(small_scene(albedo_value=1.0), NULL, res=16, spp=8)
    np.testing.assert_array_equal(img, 1.0)


@pytest.mark.parametrize("g", [0.0, 0.7])
def test_white_furnace_anisotropic(g):
    img, _ = render(small_scene(albedo_value=1.0, g=g), NULL, res=16)
    np.testing.assert_array_equal(img, 1.0)


@pytest.mark.parametrize("kernel, fields", [
    ("naiveMK", {}), ("regenerationSK", {"regeneration_level": 1}),
    ("streamingSK", {}), ("sortingSK", {}), ("streamingMK", {}),
    ("fastQ", {}), ("fastQ", {"two_level": True}),
])
def test_white_furnace_every_scheduler(kernel, fields):
    fn = make_kernel_fn(Config(kernel=Kernel.from_name(kernel), n_lanes=256,
                               **fields))
    img, n_rays = render(small_scene(albedo_value=1.0), NULL, res=16, fn=fn)
    np.testing.assert_array_equal(img, 1.0)
    assert n_rays > 16 * 16 * 4


def test_zero_density_is_background():
    dens = np.full((8, 8, 8), 1e-12, np.float32)
    scene = make_scene(make_medium(dens, np.ones(dens.shape + (3,), np.float32),
                                   scale=1.0, max_density=1.0, device="cpu"))
    img, _ = render(scene, NULL, res=16, spp=2)
    np.testing.assert_allclose(img, 1.0, atol=1e-4)


def test_absorbing_medium_darker_than_scattering():
    bright, _ = render(small_scene(albedo_value=0.95), NULL, spp=8)
    dark, _ = render(small_scene(albedo_value=0.3), NULL, spp=8)
    assert dark.mean() < bright.mean()


def test_le_scales_linearly():
    scene = small_scene()
    settings = RenderSettings.from_flags(True)
    img1, _ = render(scene, settings, res=16)
    scene.le = scene.le * 2.0
    img2, _ = render(scene, settings, res=16)
    np.testing.assert_allclose(img2, img1 * 2.0, rtol=1e-5, atol=1e-6)


# -- invariances -----------------------------------------------------------------

def test_deterministic():
    scene, settings = small_scene(), RenderSettings.from_flags(True)
    a, _ = render(scene, settings, seed=7)
    b, _ = render(scene, settings, seed=7)
    np.testing.assert_array_equal(a, b)


def test_seed_changes_noise():
    scene, settings = small_scene(), RenderSettings.from_flags(True)
    a, _ = render(scene, settings, seed=7)
    b, _ = render(scene, settings, seed=8)
    assert not np.array_equal(a, b)


def test_progressive_batching_invariance():
    """spp=4 in one launch == two launches of spp=2 with continued path-id
    bases, averaged."""
    scene, settings = small_scene(), RenderSettings.from_flags(True)
    res = 16
    one, _ = render(scene, settings, res=res, spp=4, seed=3)
    a, _ = render(scene, settings, res=res, spp=2, seed=3)
    b, _ = render(scene, settings, res=res, spp=2, seed=3, base=res * res * 2)
    np.testing.assert_allclose(one, (a + b) / 2, rtol=1e-5, atol=1e-6)


def test_ray_statistics_positive():
    _, n_rays = render(small_scene(), RenderSettings.from_flags(True), res=16,
                       spp=2)
    assert n_rays >= 16 * 16 * 2


def test_trace_stops_at_max_path_length():
    """With Russian roulette off and albedo 1, no path dies in 3 bounces
    inside a dense medium: trace stops after max_path_length bounces
    with those lanes alive and their radiance not yet added."""
    scene = small_scene(albedo_value=1.0, scale=400.0)
    settings = RenderSettings.from_flags(True, bsdf_kind="null",
                                         russian_roulette=False,
                                         max_path_length=3)
    n = 64
    o = torch.zeros(n, 3)
    d = torch.nn.functional.normalize(torch.randn(n, 3), dim=-1)
    state = integrator.initial_state(o, d, make_rng(1, torch.arange(n)))
    final = integrator.trace(scene, settings, state)
    assert float(final.n_rays) == 3 * n
    assert bool(final.alive.all()) and float(final.radiance.abs().max()) == 0


# -- the independent scalar oracle ---------------------------------------------------

def test_naive_vs_oracle_trilinear():
    """tests/test_oracle.py's naiveSK check on its asymmetric scene
    (anisotropic HG, anisotropic rough boundary, off-centre look-at
    camera, non-affine albedo): within Monte-Carlo error of the oracle,
    which shares no code with either package."""
    t = test_oracle
    dens, alb = t._grids()
    oracle_mean, oracle_se = render_oracle(
        dens, alb, (t.RES, t.RES), t.ORACLE_SPP,
        scale=t.SCALE, max_density=1.0, g=t.G, roughness=t.ROUGH,
        eta=t.INT_IOR / t.EXT_IOR, eye=t.EYE, look_at=(0, 0, 0),
        fov_x_deg=t.FOV, max_path_length=t.CAP, filtering="trilinear",
        seed=101,
    )
    scene = make_scene(
        make_medium(dens, alb, scale=t.SCALE, max_density=1.0, g=t.G,
                    device="cpu"),
        roughness=t.ROUGH, int_ior=t.INT_IOR, ext_ior=t.EXT_IOR)
    camera = make_camera_look_at(t.EYE, (0, 0, 0), (0, 1, 0), t.RES, t.RES,
                                 t.FOV, device="cpu")
    settings = RenderSettings.from_flags(True, russian_roulette=False,
                                         max_path_length=t.CAP)
    img, _ = naive.render_tile(scene, camera, settings, (t.RES, t.RES),
                               torch.zeros(2), (t.RES, t.RES), t.JAX_SPP, 3, 0)
    t._assert_within_mc_error(img.numpy() / t.JAX_SPP, oracle_mean, oracle_se,
                              t.JAX_SPP / t.ORACLE_SPP)


# -- the variable boundary ------------------------------------------------------------

def slab_scene(n=32):
    """Zero density for x < 0.5 of the unit volume, 1 from there on: an
    isosurface the march must find."""
    d = np.zeros((n, n, n), np.float32)
    d[:, :, n // 2:] = 1.0
    return make_scene(make_medium(d, np.full((n, n, n, 3), 0.9, np.float32),
                                  scale=5.0, max_density=1.0, device="cpu"))


def rays_along_x(n):
    return (torch.tensor([[-2.0, 0.0, 0.0]]).repeat(n, 1),
            torch.tensor([[1.0, 0.0, 0.0]]).repeat(n, 1))


def test_central_diff_matches_sampler():
    data = np.random.RandomState(0).rand(16, 16, 16).astype(np.float32)
    grid = Grid(torch.tensor(data))
    p = torch.tensor([[0.5, 0.4, 0.6], [0.3, 0.3, 0.3]])
    g = gradient.gradient_cd(grid, p, 0.05).numpy()
    for i, pt in enumerate(p.numpy()):
        for ax in range(3):
            dlt = np.zeros(3, np.float32)
            dlt[ax] = 0.05
            hi = float(gradient.volume_intensity(grid, torch.tensor(pt + dlt)))
            lo = float(gradient.volume_intensity(grid, torch.tensor(pt - dlt)))
            np.testing.assert_allclose(g[i, ax], lo - hi, rtol=1e-6, atol=1e-7)


def test_outside_is_zero():
    grid = Grid(torch.ones(8, 8, 8))
    assert float(gradient.volume_intensity(grid, torch.tensor([1.2, 0.5, 0.5]))) == 0


def test_sign_convention_negative_gradient():
    n = 16
    data = np.tile(np.linspace(0, 1, n, dtype=np.float32), (n, n, 1))
    g = gradient.gradient_cd(Grid(torch.tensor(data)),
                             torch.tensor([0.5, 0.5, 0.5]), 0.1).numpy()
    assert g[0] < 0.0
    np.testing.assert_allclose(g[1:], 0.0, atol=1e-6)


def test_gradient_fd_forward_difference():
    n = 16
    data = np.tile(np.linspace(0, 1, n, dtype=np.float32), (n, n, 1))
    g = gradient.gradient_fd(Grid(torch.tensor(data)),
                             torch.tensor([0.3, 0.5, 0.5]), 0.1).numpy()
    np.testing.assert_allclose(g, [-0.1, 0.0, 0.0], atol=1e-6)


def test_march_finds_slab_edge():
    scene = slab_scene()
    settings = RenderSettings.from_flags(True, boundary="variable",
                                         boundary_threshold=1e-4,
                                         russian_roulette=False)
    n = 64
    o, d = rays_along_x(n)
    med = scene.medium
    isect = aabb.aabb_intersect(med.box_min, med.box_max, o, d)
    np.testing.assert_allclose(isect.dist.numpy(), 1.5, atol=1e-5)
    isect2, _ = integrator.variable_boundary_adjust(
        scene, settings, o, d, isect, make_rng(7, torch.arange(n)),
        torch.ones(n, dtype=torch.bool))
    dist = isect2.dist.numpy()
    assert isect2.hit.all()
    assert (dist > 1.6).all() and (np.abs(dist - 2.0) < 0.3).all()
    assert (isect2.normal.numpy()[dist > 1.6, 0] < -0.9).all()


def test_no_surface_means_no_hit():
    n = 16
    scene = make_scene(make_medium(np.zeros((n, n, n), np.float32),
                                   (0.9, 0.9, 0.9), scale=5.0, max_density=1.0,
                                   device="cpu"))
    settings = RenderSettings.from_flags(True, boundary="variable",
                                         boundary_threshold=1e-4)
    o, d = rays_along_x(8)
    med = scene.medium
    isect = aabb.aabb_intersect(med.box_min, med.box_max, o, d)
    isect2, _ = integrator.variable_boundary_adjust(
        scene, settings, o, d, isect, make_rng(3, torch.arange(8)),
        torch.ones(8, dtype=torch.bool))
    assert not isect2.hit.any()
    assert isect2.inside_volume.all()  # flipped on the no-hit branch


def test_variable_boundary_matches_jax():
    """The march on rays from outside the slab scene's box (a tenth of
    them inactive), against JAX's: hits, distances and normals, and the
    RNG states bit for bit."""
    n = 32
    d3 = np.zeros((n, n, n), np.float32)
    d3[:, :, n // 2:] = 1.0
    alb = np.full((n, n, n, 3), 0.9, np.float32)
    js = jtypes.make_scene(jtypes.make_medium(d3, alb, scale=5.0,
                                              max_density=1.0))
    m = js.medium
    ts = convert.scene_from_arrays(
        m.density.data, m.albedo.data, m.albedo_affine, m.box_min, m.box_max,
        m.scale, m.max_density, m.g, js.bsdf.roughness, js.bsdf.eta, js.le)
    rs = np.random.RandomState(4)
    k = 256
    o = np.concatenate([np.full((k, 1), -2.0), rs.uniform(-0.45, 0.45, (k, 2))],
                       -1).astype(np.float32)
    d = np.concatenate([np.ones((k, 1)), rs.uniform(-0.3, 0.3, (k, 2))], -1)
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    active = rs.rand(k) < 0.9
    kw = dict(boundary="variable", boundary_threshold=1e-4)
    ji = jaabb.aabb_intersect(m.box_min, m.box_max, jnp.asarray(o),
                              jnp.asarray(d))
    want, jr = jax.jit(jint.variable_boundary_adjust, static_argnums=(1,))(
        js, jtypes.RenderSettings.from_flags(True, **kw), jnp.asarray(o),
        jnp.asarray(d), ji, jrng.make_rng(9, jnp.arange(k, dtype=jnp.uint32)),
        jnp.asarray(active))
    tm = ts.medium
    ti = aabb.aabb_intersect(tm.box_min, tm.box_max, torch.tensor(o),
                             torch.tensor(d))
    got, tr = integrator.variable_boundary_adjust(
        ts, RenderSettings.from_flags(True, **kw), torch.tensor(o),
        torch.tensor(d), ti, make_rng(9, torch.arange(k)),
        torch.tensor(active))
    for name in ("hit", "inside_volume"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)))
    for name in ("dist", "normal"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(tr.state.numpy(),
                                  np.asarray(jr.state).astype(np.int64))
    moved = got.dist.numpy() > ti.dist.numpy() + 0.1
    assert moved.sum() > k // 4 and not moved[~active].any()


def test_render_runs_and_differs_from_aabb():
    scene = slab_scene()
    cam = make_camera(16, 16, 35.0, position=(0.0, 0.0, 3.0), device="cpu")
    imgs = {}
    for boundary in ("aabb", "variable"):
        settings = RenderSettings.from_flags(
            True, boundary=boundary, boundary_threshold=1e-4,
            max_path_length=16)
        img, n_rays = naive.render_tile(scene, cam, settings, (16, 16),
                                        torch.zeros(2), (16, 16), 2, 11, 0)
        assert np.isfinite(img.numpy()).all() and float(n_rays) > 0
        imgs[boundary] = img.numpy()
    assert not np.array_equal(imgs["aabb"], imgs["variable"])


@pytest.mark.parametrize("kernel", ["naiveSK", "streamingSK"])
def test_white_furnace_conserves_with_null_bsdf(kernel):
    """The variable boundary moves events but creates and destroys no
    energy: every pixel stays exactly 1."""
    n = 16
    d = np.zeros((n, n, n), np.float32)
    d[:, :, n // 2:] = 1.0
    scene = make_scene(make_medium(d, 1.0, scale=3.0, max_density=1.0,
                                   device="cpu"))
    settings = RenderSettings.from_flags(
        True, boundary="variable", boundary_threshold=1e-4, bsdf_kind="null",
        russian_roulette=False, max_path_length=200)
    fn = make_kernel_fn(Config(kernel=Kernel.from_name(kernel), n_lanes=256,
                               settings=settings))
    img, _ = fn(scene, make_camera(8, 8, 35.0, position=(0.0, 0.0, 3.0),
                                   device="cpu"),
                settings, (8, 8), torch.zeros(2), (8, 8), 4, 5, 0)
    np.testing.assert_allclose(img.numpy() / 4, 1.0, rtol=0, atol=1e-5)
