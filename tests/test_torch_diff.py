"""The port's differentiable path (models/differentiable.py) on the CPU.

render_diff against the JAX package's render_diff, one- and two-level,
on the same 16^3 grids and seed: the image and both cotangents (density
by the score function, albedo reparameterised) under one fixed image
cotangent.  On the null-BSDF scene the two packages trace the same
paths: images allclose at rtol = atol = 1e-4 and every voxel of both
cotangents within rtol 1e-3, atol 1e-4 x max|grad|.  On the GGX scene
XLA's transcendentals differ from torch's in the last bits
(tests/test_torch_schedulers.py), and near grazing GGX's G1 weight and
direction turn that into ~1e-4 of a lane's radiance on ~5% of lanes
and a different weight or path on ~1% (two-level: 12 of 256 pixels
differ by more than 1e-4); there at least 99% of voxels and 90% of
pixels are held to those tolerances and the image mean to 1e-3.  In
every case the cotangents' sums agree to 1e-3 of their absolute sums.
Each share is printed.

The rest are the analogs of tests/test_grad.py on the port alone (the
finite-difference and analytic checks, fused against nested replay,
cascaded against uncascaded), the pass-A elision, and the fused
replay's host loop reading its condition every k evaluations against
every evaluation.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cudavolumerenderer_tpu.models import differentiable as jd
from cudavolumerenderer_tpu.scene.types import RenderSettings as JSettings
from cudavolumerenderer_tpu_torch import convert
from cudavolumerenderer_tpu_torch.models import differentiable as td
from cudavolumerenderer_tpu_torch.models import naive
from cudavolumerenderer_tpu_torch.models.differentiable import (
    CameraSpec,
    SceneSpec,
    render_diff,
)
from cudavolumerenderer_tpu_torch.ops import grid as tgrid
from cudavolumerenderer_tpu_torch.scene.types import RenderSettings

torch.set_num_threads(2)

IMG_TOL = dict(rtol=1e-4, atol=1e-4)


# -- render_diff against JAX's ---------------------------------------------------

N, RES16, SPP16, SEED16 = 16, (16, 16), 4, 7
J_SPEC16 = jd.SceneSpec(scale=4.0, max_density=1.0)
J_CAM16 = jd.CameraSpec(res_x=16, res_y=16, fov_x_deg=0.5)


def case_inputs():
    """Random 16^3 density and per-voxel albedo, and the image cotangent."""
    rs = np.random.RandomState(0)
    density = (rs.rand(N, N, N) * 0.8).astype(np.float32)
    albedo = (0.3 + 0.6 * rs.rand(N, N, N, 4)).astype(np.float32)
    g_img = rs.rand(*RES16, 3).astype(np.float32)
    return density, albedo, g_img


def case_settings(bsdf):
    return dict(russian_roulette=False, max_path_length=16, bsdf_kind=bsdf)


@pytest.fixture(scope="module")
def jax_cases():
    density, albedo, g_img = case_inputs()
    out = {}
    for bsdf in ("null", "ggx"):
        settings = JSettings.from_flags(True, **case_settings(bsdf))
        for two in (False, True):
            img, vjp = jax.vjp(
                lambda d, a: jd.render_diff(
                    d, a, SEED16, J_SPEC16, J_CAM16, settings, RES16, SPP16,
                    two,
                ),
                jnp.asarray(density), jnp.asarray(albedo),
            )
            dd, da = vjp(jnp.asarray(g_img))
            out[bsdf, two] = tuple(np.asarray(x) for x in (img, dd, da))
    return out


def port_case(bsdf, two):
    density, albedo, g_img = case_inputs()
    d = torch.tensor(density, requires_grad=True)
    a = torch.tensor(albedo, requires_grad=True)
    img = render_diff(
        d, a, SEED16, convert.scene_spec_from_jax(J_SPEC16),
        convert.camera_spec_from_jax(J_CAM16),
        RenderSettings.from_flags(True, **case_settings(bsdf)), RES16,
        SPP16, two,
    )
    img.backward(torch.tensor(g_img))
    return img.detach().numpy(), d.grad.numpy(), a.grad.numpy()


def grad_share(got, want):
    """Share of entries within rtol 1e-3, atol 1e-4 x max|want|."""
    ok = np.isclose(got, want, rtol=1e-3, atol=1e-4 * np.abs(want).max())
    return float(ok.mean())


@pytest.mark.parametrize("two", [False, True], ids=["one-level", "two-level"])
@pytest.mark.parametrize("bsdf", ["null", "ggx"])
def test_render_diff_matches_jax(jax_cases, bsdf, two):
    (ti, tdd, tda), (ji, jdd, jda) = port_case(bsdf, two), jax_cases[bsdf, two]
    assert ti.shape == (16, 16, 3) and np.isfinite(ti).all()
    assert np.isfinite(tdd).all() and np.isfinite(tda).all()
    pixels = float(np.all(np.isclose(ti, ji, **IMG_TOL), axis=-1).mean())
    shares = {"density": grad_share(tdd, jdd), "albedo": grad_share(tda, jda)}
    print(f"{bsdf} two_level={two}: pixels within 1e-4 {pixels:.4f}, max "
          f"|diff| {np.abs(ti - ji).max():.3g}; voxels within tolerance "
          + ", ".join(f"{k} {v:.4f}" for k, v in shares.items()))
    for got, want in ((tdd, jdd), (tda, jda)):
        assert abs(got.sum() - want.sum()) <= 1e-3 * np.abs(want).sum()
    if bsdf == "null":
        np.testing.assert_allclose(ti, ji, **IMG_TOL)
        assert shares == {"density": 1.0, "albedo": 1.0}
    else:
        assert pixels >= 0.9
        assert min(shares.values()) >= 0.99
        assert abs(ti.mean() - ji.mean()) <= 1e-3 * ji.mean()


def test_specs_carry_across_and_build_on_the_card_by_default():
    # values exact in float32, so from_scene gives the spec back
    fields = dict(scale=3.0, g=0.25, roughness=(0.125, 0.25), eta=1.5)
    spec = convert.scene_spec_from_jax(jd.SceneSpec(**fields))
    assert spec == SceneSpec(**fields)
    look = jd.CameraSpec(res_x=8, res_y=4, position=(1.0, 2.0, 90.0),
                         look_at=(0.0, 0.0, 0.0))
    assert convert.camera_spec_from_jax(look) == CameraSpec(
        res_x=8, res_y=4, position=(1.0, 2.0, 90.0), look_at=(0.0, 0.0, 0.0))
    scene = spec.build(np.ones((2, 2, 2), np.float32),
                       np.ones((1, 1, 1, 4), np.float32), device="cpu")
    assert SceneSpec.from_scene(scene) == spec
    if torch.cuda.is_available():
        pytest.skip("a card is present: build's default device works")
    with pytest.raises(RuntimeError, match="CUDA"):
        spec.build(np.ones((2, 2, 2), np.float32),
                   np.ones((1, 1, 1, 4), np.float32))
    with pytest.raises(RuntimeError, match="CUDA"):
        CameraSpec().build()


def test_look_at_camera_matches_jax():
    look = jd.CameraSpec(res_x=8, res_y=6, fov_x_deg=0.8,
                         position=(70.0, 0.0, 70.0), look_at=(0.0, 0.0, 0.0))
    for spec in (look, jd.CameraSpec(res_x=8, res_y=6)):
        jc = spec.build()
        tc = convert.camera_spec_from_jax(spec).build("cpu")
        np.testing.assert_allclose(tc.inv_view.numpy(), np.asarray(jc.inv_view),
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_array_equal(tc.raster_to_view.numpy(),
                                      np.asarray(jc.raster_to_view))


def test_trilerp_taps_match_jax_and_the_sampler():
    rs = np.random.RandomState(3)
    data = rs.rand(5, 7, 6).astype(np.float32)
    p = (rs.rand(500, 3) * 1.2 - 0.6).astype(np.float32)  # some outside
    lo, hi = np.float32([-0.5] * 3), np.float32([0.5] * 3)
    jt = jd._trilerp_taps(data.shape, jnp.asarray(lo), jnp.asarray(hi),
                          jnp.asarray(p))
    tt = td._trilerp_taps(data.shape, torch.tensor(lo), torch.tensor(hi),
                          torch.tensor(p))
    value = 0.0
    for (ji, jw), (ti, tw) in zip(jt, tt):
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
        value = value + data.reshape(-1)[ti.numpy()] * tw.numpy()
    p01 = (torch.tensor(p) - torch.tensor(lo)) / torch.tensor(hi - lo)
    want = tgrid.sample_trilinear(tgrid.Grid(torch.tensor(data)), p01)
    np.testing.assert_allclose(value, want.numpy(), rtol=1e-5, atol=1e-6)


def test_brick_tables_match_jax():
    density = case_inputs()[0]
    density[:8, :8, :8] = 0.0  # empty bricks: a live Chebyshev channel
    for max_bricks in (None, 8):
        jmaj, jcheb, jbrick = jax_brick_tab(density, max_bricks)
        tmaj, tcheb, tbrick = td._build_brick_tab(torch.tensor(density),
                                                  max_bricks)
        assert tuple(tbrick) == tuple(jbrick)
        np.testing.assert_array_equal(tmaj.numpy(), np.asarray(jmaj))
        np.testing.assert_array_equal(tcheb.numpy(), np.asarray(jcheb))


def jax_brick_tab(density, max_bricks):
    """JAX's tables under its module global DIFF_MAX_BRICKS, restored."""
    old = jd.DIFF_MAX_BRICKS
    jd.DIFF_MAX_BRICKS = max_bricks
    try:
        return jd._build_brick_tab(jnp.asarray(density))
    finally:
        jd.DIFF_MAX_BRICKS = old


# -- analogs of tests/test_grad.py on the port -----------------------------------

RES = (4, 4)
SPEC = SceneSpec(scale=2.0, max_density=1.0)
# fov narrow enough that every ray crosses the box
CAM = CameraSpec(res_x=4, res_y=4, fov_x_deg=0.4)


def settings_nr(max_len=16):
    return RenderSettings.from_flags(
        True, russian_roulette=False, max_path_length=max_len,
        bsdf_kind="null",
    )


def grids(rho=0.5, alb=0.6, n=4):
    return (torch.full((n, n, n), rho, dtype=torch.float32),
            torch.full((n, n, n, 4), alb, dtype=torch.float32))


def grad_of(loss, x):
    x = x.clone().requires_grad_(True)
    value = loss(x)
    (g,) = torch.autograd.grad(value, x)
    return value.detach(), g


@pytest.mark.parametrize("two", [False, True], ids=["one-level", "two-level"])
def test_albedo_matches_fixed_seed_finite_differences(two):
    """RR off => trajectories independent of albedo => same-seed FD is
    exact for the albedo gradient."""
    density, albedo = grids()
    settings = settings_nr()

    def loss(a):
        return torch.sum(render_diff(density, a, 3, SPEC, CAM, settings, RES,
                                     8, two))

    _, g = grad_of(loss, albedo)
    h = 1e-3
    direction = torch.zeros_like(albedo)
    direction[..., :3] = 1.0
    fd = (loss(albedo + h * direction) - loss(albedo - h * direction)) / (2 * h)
    np.testing.assert_allclose(float(torch.sum(g * direction)), float(fd),
                               rtol=2e-2, atol=1e-3)


def test_albedo_gradient_is_positive():
    density, albedo = grids()
    _, g = grad_of(lambda a: torch.sum(render_diff(
        density, a, 1, SPEC, CAM, settings_nr(), RES, 4)), albedo)
    assert float(torch.sum(g)) > 0.0


@pytest.mark.parametrize("two", [False, True], ids=["one-level", "two-level"])
def test_density_matches_analytic_transmittance_derivative(two):
    """Absorption only: E[pixel] = exp(-scale*rho*L); the summed density
    gradient must match dE/drho."""
    rho = 0.5
    density = torch.full((4, 4, 4), rho)
    albedo = torch.zeros((4, 4, 4, 4))
    spp = 2500

    def loss(dgrid):
        img = render_diff(dgrid, albedo, 11, SPEC, CAM, settings_nr(8), RES,
                          spp, two)
        return torch.mean(img[..., 0]) / spp

    val, g = grad_of(loss, density)
    assert abs(float(val) - np.exp(-2.0 * rho)) < 0.03
    d_e = -2.0 * np.exp(-2.0 * rho)
    assert abs(float(torch.sum(g)) - d_e) / abs(d_e) < 0.15


def test_density_gradient_sign():
    density, _ = grids(rho=0.4)
    albedo = torch.zeros((4, 4, 4, 4))
    _, g = grad_of(lambda d: torch.sum(render_diff(
        d, albedo, 5, SPEC, CAM, settings_nr(8), RES, 64)), density)
    assert float(torch.sum(g)) < 0.0


def test_per_voxel_density_grad_sign_pattern():
    density = torch.full((4, 4, 4), 0.5)
    albedo = torch.zeros((4, 4, 4, 4))
    _, g = grad_of(lambda d: torch.mean(render_diff(
        d, albedo, 31, SPEC, CAM, settings_nr(8), RES, 400)[..., 0]) / 400,
        density)
    g = g.numpy()
    assert g.sum() < 0
    # the beam is a narrow pencil through the volume centre in x/y
    center = np.abs(g[:, 1:3, 1:3]).sum()
    corners = np.abs(g[:, 0, 0]).sum() + np.abs(g[:, -1, -1]).sum()
    assert center > corners


def test_pixel_gradient_allclose_rate():
    """Per-pixel directional derivatives along the albedo against
    same-seed finite differences (exact with RR off)."""
    density, albedo = grids()
    settings = settings_nr()

    def image(a):
        return render_diff(density, a, 13, SPEC, CAM, settings, RES, 16)

    direction = torch.zeros_like(albedo)
    direction[..., :3] = 1.0
    a = albedo.clone().requires_grad_(True)
    img = image(a)
    h = 1e-3
    fd = (image(albedo + h * direction) - image(albedo - h * direction)) / (2 * h)
    rs = np.random.RandomState(0)
    n_ok = 0
    for _ in range(10):
        i, j, c = rs.randint(4), rs.randint(4), rs.randint(3)
        ct = torch.zeros_like(img)
        ct[i, j, c] = 1.0
        (grad_a,) = torch.autograd.grad(img, a, ct, retain_graph=True)
        analytic = float(torch.sum(grad_a * direction))
        expected = float(fd[i, j, c])
        n_ok += abs(analytic - expected) <= 0.05 * abs(expected) + 1e-3
    assert n_ok / 10 >= 0.9


def test_one_gradient_step_reduces_loss():
    density, albedo = grids(rho=0.5, alb=0.0)
    settings = settings_nr(8)
    spp = 256
    target = render_diff(density, albedo, 21, SPEC, CAM, settings, RES,
                         spp) / spp

    def loss(d):
        img = render_diff(d, albedo, 22, SPEC, CAM, settings, RES, spp) / spp
        return torch.mean((img - target) ** 2)

    l0, g = grad_of(loss, density * 1.6)
    d1 = torch.clamp(density * 1.6 - 25.0 * g, 0.0, 1.0)
    assert float(loss(d1)) < float(l0)


def test_two_level_forward_matches_naive_estimator_mean():
    density, albedo = grids(rho=0.6, alb=0.7)
    settings = settings_nr(16)
    a = render_diff(density, albedo, 3, SPEC, CAM, settings, RES, 256)
    b = render_diff(density, albedo, 4, SPEC, CAM, settings, RES, 256, True)
    ma, mb = float(a.mean()), float(b.mean())
    assert abs(ma - mb) / ma < 0.05, (ma, mb)


# -- replays -----------------------------------------------------------------------

def replay_setup(res=RES, spp=4, seed=123, full_albedo=False):
    """(scene, tables, lanes, s_lane, g_lane) for the replay tests; a
    random per-voxel albedo with full_albedo."""
    density, albedo = grids()
    if full_albedo:
        albedo = torch.tensor(
            0.3 + 0.6 * np.random.RandomState(5).rand(4, 4, 4, 4),
            dtype=torch.float32)
    scene = SPEC.build(density, albedo, device="cpu")
    tables = td._build_brick_tab(density)
    cam_obj = CameraSpec(res_x=res[0], res_y=res[1], fov_x_deg=0.4).build("cpu")
    lanes = td._lane_setup(cam_obj, res, spp, seed)
    n = lanes[0]
    return scene, tables, lanes, torch.full((n,), 0.5), torch.full((n, 3), 0.25)


def replay(scene, settings, lanes, s_lane, g_lane, tables, record=True, **kw):
    n, _, o0, d0, rng = lanes
    n_alb = scene.medium.albedo.data.numel() // 4
    return td._replay(
        scene, settings, o0, d0, rng, s_lane, g_lane, record,
        torch.zeros(scene.medium.density.data.numel()), torch.zeros(n_alb, 4),
        tables, **kw,
    )


def test_fused_replay_matches_nested():
    """Radiance and throughput bit-equal (the same per-lane draws); the
    cotangents accumulate the same terms in another grouping."""
    scene, tables, lanes, s_lane, g_lane = replay_setup()
    outs = {fused: replay(scene, settings_nr(12), lanes, s_lane, g_lane,
                          tables, fused=fused) for fused in (False, True)}
    for field in ("radiance", "throughput"):
        np.testing.assert_array_equal(getattr(outs[False], field).numpy(),
                                      getattr(outs[True], field).numpy())
    for field in ("d_density", "d_albedo"):
        np.testing.assert_allclose(getattr(outs[False], field).numpy(),
                                   getattr(outs[True], field).numpy(),
                                   rtol=1e-6, atol=1e-6, err_msg=field)
    for field in ("o", "d"):
        np.testing.assert_allclose(getattr(outs[False], field).numpy(),
                                   getattr(outs[True], field).numpy(),
                                   atol=1e-6, err_msg=field)


def test_fused_replay_matches_nested_with_rr():
    scene, tables, lanes, _, _ = replay_setup(spp=2, seed=77)
    n = lanes[0]
    settings = RenderSettings.from_flags(True, russian_roulette=True,
                                         max_path_length=16)
    outs = [replay(scene, settings, lanes, torch.zeros(n), torch.zeros(n, 3),
                   tables, record=False, fused=fused) for fused in (False, True)]
    np.testing.assert_array_equal(outs[0].radiance.numpy(),
                                  outs[1].radiance.numpy())


def test_cascade_replay_matches_uncascaded():
    """512 lanes with min_width 64: pools of 512, 256, 128 and 64 lanes.
    Radiance and throughput bit-equal, cotangents allclose."""
    scene, tables, lanes, s_lane, g_lane = replay_setup(res=(8, 8), spp=8)
    settings = settings_nr(12)
    stats = {}
    outs = {
        casc: replay(scene, settings, lanes, s_lane, g_lane, tables,
                     cascade=casc, min_width=64,
                     stats=stats if casc else None)
        for casc in (False, True)
    }
    assert stats["rows"] < stats["iterations"] * 512  # the pools narrowed
    for field in ("radiance", "throughput"):
        np.testing.assert_array_equal(getattr(outs[False], field).numpy(),
                                      getattr(outs[True], field).numpy())
    for field in ("d_density", "d_albedo", "o", "d"):
        np.testing.assert_allclose(getattr(outs[False], field).numpy(),
                                   getattr(outs[True], field).numpy(),
                                   rtol=1e-6, atol=1e-6, err_msg=field)


@pytest.mark.parametrize("check_every", [1, 3])
def test_fused_replay_reads_its_condition_every_k_evaluations(check_every):
    """Reading the pending count every k evaluations gives what reading it
    every evaluation gives, bit for bit: an evaluation past the exit
    changes nothing, and a lane advances one step per evaluation whatever
    pool holds it (per-voxel albedo, so every cotangent is an
    index_add_ in lane order)."""
    scene, tables, lanes, s_lane, g_lane = replay_setup(
        res=(8, 8), spp=8, full_albedo=True)
    settings = RenderSettings.from_flags(True, russian_roulette=True,
                                         max_path_length=16)
    runs = [replay(scene, settings, lanes, s_lane, g_lane, tables,
                   min_width=64, check_every=k) for k in (check_every, 8)]
    for field in ("o", "d", "throughput", "radiance", "d_density", "d_albedo"):
        np.testing.assert_array_equal(getattr(runs[0], field).numpy(),
                                      getattr(runs[1], field).numpy(),
                                      err_msg=field)


def test_pass_a_elision_is_bit_equal():
    """The radiance the two-level forward keeps is the radiance pass A
    would recompute, and pass B's own paths give it again."""
    density, albedo = grids()
    albedo = albedo * 1.2
    settings = RenderSettings.from_flags(True, russian_roulette=True,
                                         max_path_length=16)
    scene = SPEC.build(density, albedo, device="cpu")
    cam_obj = CAM.build("cpu")
    img, saved = td._primal_2l(scene, cam_obj, settings, RES, 8, 9, density,
                               albedo)
    lanes = td._lane_setup(cam_obj, RES, 8, 9)
    n = lanes[0]
    tables = td._build_brick_tab(density)
    pass_a = replay(scene, settings, lanes, torch.zeros(n), torch.zeros(n, 3),
                    tables, record=False)
    pass_b = replay(scene, settings, lanes, torch.full((n,), 0.3),
                    torch.full((n, 3), 0.1),
                    tables)
    np.testing.assert_array_equal(pass_a.radiance.numpy(), saved.numpy())
    np.testing.assert_array_equal(pass_b.radiance.numpy(), saved.numpy())
    np.testing.assert_array_equal(
        img.numpy(), naive.splat(lanes[1], saved, RES).numpy())


def test_one_level_pass_a_matches_the_forward():
    """The one-level forward is naive.render_tile; pass A's replay of the
    same lanes gives its image bit for bit (GGX, RR on)."""
    density, albedo = grids(alb=0.8)
    settings = RenderSettings.from_flags(True, max_path_length=16)
    scene = SPEC.build(density, albedo, device="cpu")
    img = render_diff(density, albedo, 4, SPEC, CAM, settings, RES, 8)
    lanes = td._lane_setup(CAM.build("cpu"), RES, 8, 4)
    n = lanes[0]
    pass_a = replay(scene, settings, lanes, torch.zeros(n), torch.zeros(n, 3),
                    None, record=False)
    np.testing.assert_array_equal(
        img.numpy(), naive.splat(lanes[1], pass_a.radiance, RES).numpy())


def test_render_diff_stats_count_the_replay():
    density, albedo = grids()
    d = density.clone().requires_grad_(True)
    stats = {}
    img = render_diff(d, albedo, 2, SPEC, CAM, settings_nr(), RES, 4, True,
                      stats=stats)
    img.sum().backward()
    assert stats["primal_iters"] == stats["pass_b_iters"]
    assert stats["primal_iters"][0] > 0 and stats["primal_iters"][0] % 8 == 0
