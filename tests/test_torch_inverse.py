"""The port's inverse rendering (models/inverse.py) on the CPU.

run_inverse and run_inverse_views against the JAX package's on
test_inverse.py's 6^3 null-BSDF scene, from the same target made by JAX:
the loss trajectory within rtol 1e-3 and the final grid within atol
1e-3.  A checkpoint written by JAX resumes in the port (and the port's
in JAX), the port's own resume equals its unbroken run bit for bit, and
the pyramid resumes from its deepest level.  The numpy diagnostics and
the pyramid's upsampling against JAX's.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cudavolumerenderer_tpu.models import differentiable as jd
from cudavolumerenderer_tpu.models import inverse as ji
from cudavolumerenderer_tpu.scene import procedural as jproc
from cudavolumerenderer_tpu.scene.types import RenderSettings as JSettings
from cudavolumerenderer_tpu_torch import convert
from cudavolumerenderer_tpu_torch.models import inverse as ti
from cudavolumerenderer_tpu_torch.scene import procedural
from cudavolumerenderer_tpu_torch.scene.types import RenderSettings

torch.set_num_threads(2)

TRAJ_TOL = dict(rtol=1e-3, atol=0.0)
GRID_TOL = dict(rtol=0.0, atol=1e-3)
FLAGS = dict(russian_roulette=False, max_path_length=8, bsdf_kind="null")
VIEW_BASE = dict(resolution=(8, 8), spp=16, learning_rate=0.05, seed=11,
                 views_per_step=2)


def jax_setup(n=6):
    """test_inverse.py's setup(): scene, camera, settings, grids."""
    spec = jd.SceneSpec(scale=2.5, max_density=1.0)
    cam = jd.CameraSpec(res_x=8, res_y=8, fov_x_deg=0.4)
    settings = JSettings.from_flags(True, **FLAGS)
    rs = np.random.RandomState(0)
    density = (0.3 + 0.4 * rs.rand(n, n, n)).astype(np.float32)
    albedo = np.zeros((n, n, n, 4), np.float32)
    return spec, cam, settings, density, albedo


def port_args(spec, cam):
    return (convert.scene_spec_from_jax(spec), convert.camera_spec_from_jax(cam),
            RenderSettings.from_flags(True, **FLAGS))


def view_cams(spec_cls=ji):
    return spec_cls.orbit_camera_specs(2, radius=100.0, res=(8, 8),
                                       fov_x_deg=0.4)


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """JAX's 12-step run_inverse, and its 8-step run_inverse_views with a
    checkpoint every 2 steps."""
    spec, cam, settings, density, albedo = jax_setup()
    target = np.asarray(jd.render_diff(
        jnp.asarray(density), jnp.asarray(albedo), 999, spec, cam, settings,
        (8, 8), 256) / 256.0)
    d0 = np.clip(density * 1.7, 0.0, 1.0)
    config = ji.InverseConfig(resolution=(8, 8), spp=96, learning_rate=0.05,
                              n_steps=12)
    d_fit, _, losses = ji.run_inverse(jnp.asarray(target), jnp.asarray(d0),
                                      jnp.asarray(albedo), spec, cam, settings,
                                      config)

    cams = view_cams()
    targets = np.asarray(ji.render_view_targets(
        jnp.asarray(density), jnp.asarray(albedo), spec, cams, settings,
        (8, 8), 32, False))
    ck = str(tmp_path_factory.mktemp("jax_ck"))
    vcfg = ji.InverseConfig(n_steps=8, checkpoint_dir=ck, checkpoint_every=2,
                            **VIEW_BASE)
    d_views, losses_views, _ = ji.run_inverse_views(
        jnp.asarray(targets), cams, jnp.full(density.shape, 0.4), albedo, spec,
        settings, vcfg)
    return dict(target=target, d0=d0, d_fit=np.asarray(d_fit), losses=losses,
                targets=targets, ck=ck, d_views=np.asarray(d_views),
                losses_views=losses_views)


def port_views(targets, d0, n_steps, **kw):
    spec, _, _, _, albedo = jax_setup()
    tspec, _, tsettings = port_args(spec, jd.CameraSpec())
    cams = tuple(convert.camera_spec_from_jax(c) for c in view_cams())
    cfg = ti.InverseConfig(n_steps=n_steps, **{
        k: v for k, v in kw.items() if k in ("checkpoint_dir",
                                             "checkpoint_every")}, **VIEW_BASE)
    extra = {k: v for k, v in kw.items() if k in ("opt_state", "start_step")}
    return ti.run_inverse_views(targets, cams, d0, albedo, tspec, tsettings,
                                cfg, device="cpu", **extra)


def test_run_inverse_trajectory_matches_jax(jax_runs):
    spec, cam, _, density, albedo = jax_setup()
    config = ti.InverseConfig(resolution=(8, 8), spp=96, learning_rate=0.05,
                              n_steps=12)
    d_fit, _, losses = ti.run_inverse(jax_runs["target"], jax_runs["d0"],
                                      albedo, *port_args(spec, cam), config,
                                      device="cpu")
    rel = np.abs(np.subtract(losses, jax_runs["losses"])) / jax_runs["losses"]
    print(f"run_inverse: 12 losses, max relative difference {rel.max():.3g}; "
          f"grid max |diff| {np.abs(d_fit.numpy() - jax_runs['d_fit']).max():.3g}")
    np.testing.assert_allclose(losses, jax_runs["losses"], **TRAJ_TOL)
    np.testing.assert_allclose(d_fit.numpy(), jax_runs["d_fit"], **GRID_TOL)
    assert losses[-1] < losses[0] * 0.7
    assert np.mean((d_fit.numpy() - density) ** 2) < np.mean(
        (jax_runs["d0"] - density) ** 2)


def test_run_inverse_views_trajectory_matches_jax(jax_runs, tmp_path):
    """The first four steps and the grid after them.  Later the two drift
    apart: a voxel's score terms cancel, so the order of its sum (XLA's
    scatter against index_add_) moves its Adam update by ~1e-6 a step,
    and by step 6 one Woodcock decision flips (each package alone is
    exact: test_port_resume_matches_unbroken_run)."""
    ck = str(tmp_path / "ck")
    _, losses, _ = port_views(jax_runs["targets"],
                              np.full((6, 6, 6), 0.4, np.float32), 4,
                              checkpoint_dir=ck, checkpoint_every=4)
    np.testing.assert_allclose(losses, jax_runs["losses_views"][:4],
                               **TRAJ_TOL)
    np.testing.assert_allclose(ti.load_checkpoint(ck, 4)[0],
                               ji.load_checkpoint(jax_runs["ck"], 4)[0],
                               **GRID_TOL)


def test_jax_checkpoint_resumes_in_the_port(jax_runs):
    """JAX's step-6 checkpoint, Adam moments included, carries the port
    through steps 6-7 onto JAX's unbroken run."""
    tpl = ti.adam_init([torch.zeros((6, 6, 6))])
    d_ck, _, step, opt = ti.load_checkpoint(jax_runs["ck"], 6,
                                            opt_state_like=tpl)
    assert step == 6 and opt is not None and opt.count == 6
    d_res, losses, _ = port_views(jax_runs["targets"], d_ck, 8,
                                  opt_state=opt, start_step=6)
    np.testing.assert_allclose(losses, jax_runs["losses_views"][6:],
                               **TRAJ_TOL)
    np.testing.assert_allclose(d_res.numpy(), jax_runs["d_views"], **GRID_TOL)
    # without its moments the resumed run leaves JAX's: they matter
    d_reset, _, _ = port_views(jax_runs["targets"], d_ck, 8, start_step=6)
    assert np.abs(d_reset.numpy() - jax_runs["d_views"]).max() > 1e-2


def test_adam_leaves_are_optax_order():
    """AdamState.leaves() is jax.tree_util.tree_leaves of optax.adam's
    state, and convert carries those leaves into the port's AdamState."""
    rs = np.random.RandomState(2)
    params = (rs.rand(3, 3, 3).astype(np.float32),
              rs.rand(2, 2, 2, 4).astype(np.float32))
    grads = tuple(rs.randn(*p.shape).astype(np.float32) for p in params)
    opt = optax.adam(0.1)
    state = opt.init(tuple(jnp.asarray(p) for p in params))
    _, state = opt.update(tuple(jnp.asarray(g) for g in grads), state)
    leaves = [np.asarray(x) for x in jax.tree_util.tree_leaves(state)]
    carried = convert.adam_state_from_optax_leaves(leaves)
    assert carried.count == 1 and len(carried.leaves()) == len(leaves) == 5
    for got, want in zip(carried.leaves()[1:], leaves[1:]):
        np.testing.assert_array_equal(got.numpy(), want)
    # the same first step in torch.optim.Adam gives the same moments
    tparams = [torch.tensor(p, requires_grad=True) for p in params]
    topt = ti.make_adam(tparams, 0.1)
    for p, g in zip(tparams, grads):
        p.grad = torch.tensor(g)
    topt.step()
    mine = ti.adam_state(topt)
    assert mine.count == 1
    for got, want in zip(mine.leaves()[1:], leaves[1:]):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-9)
    with pytest.raises(ValueError):
        convert.adam_state_from_optax_leaves(leaves[:4])


def test_port_checkpoint_loads_in_jax(tmp_path):
    d = np.random.RandomState(4).rand(4, 4, 4).astype(np.float32)
    p = torch.tensor(d, requires_grad=True)
    opt = ti.make_adam([p], 0.05)
    p.grad = torch.ones_like(p)
    opt.step()
    ti._save_checkpoint(str(tmp_path), 3, p, np.zeros((1, 1, 1, 4)),
                        ti.adam_state(opt), seed=5)
    tpl = optax.adam(0.05).init(jnp.zeros((4, 4, 4), jnp.float32))
    d_ck, _, step, restored = ji.load_checkpoint(str(tmp_path), 3,
                                                 opt_state_like=tpl)
    assert step == 3 and int(restored[0].count) == 1
    np.testing.assert_array_equal(np.asarray(d_ck), p.detach().numpy())
    np.testing.assert_array_equal(np.asarray(restored[0].mu),
                                  opt.state[p]["exp_avg"].numpy())


def test_port_resume_matches_unbroken_run(jax_runs, tmp_path):
    """Killed at step 3 and resumed from its checkpoint, the port repeats
    its unbroken run exactly (test_inverse.py's analog)."""
    d0 = np.full((6, 6, 6), 0.4, np.float32)
    d_full, losses_full, _ = port_views(jax_runs["targets"], d0, 6)
    ck = str(tmp_path / "ck")
    port_views(jax_runs["targets"], d0, 3, checkpoint_dir=ck,
               checkpoint_every=1)
    assert ti.find_latest_checkpoint(ck) == 3
    assert ti.find_latest_checkpoint(str(tmp_path / "none")) is None
    d_ck, _, step, opt = ti.load_checkpoint(
        ck, 3, opt_state_like=ti.adam_init([torch.zeros((6, 6, 6))]))
    d_res, losses_res, _ = port_views(jax_runs["targets"], d_ck, 6,
                                      opt_state=opt, start_step=step)
    assert losses_res == losses_full[3:]
    np.testing.assert_array_equal(d_res.numpy(), d_full.numpy())


def test_pyramid_resume(tmp_path):
    """The pyramid resumes from its deepest checkpointed level and ends
    bit-identical to the unbroken pyramid."""
    gt = procedural.blob_volume((8, 8, 8), n_blobs=2)
    albedo = np.full((1, 1, 1, 4), 0.6, np.float32)
    spec = ti.SceneSpec(scale=8.0, max_density=1.0)
    settings = RenderSettings.from_flags(True, russian_roulette=False,
                                         max_path_length=8)
    views = ti.orbit_camera_specs(2, radius=100.0, res=(8, 8), fov_x_deg=0.8)
    targets = ti.render_view_targets(gt, albedo, spec, views, settings,
                                     (8, 8), 16, False, device="cpu")
    assert targets.shape == (2, 8, 8, 3) and torch.isfinite(targets).all()
    levels = [(4, 2), (8, 4)]
    ck = str(tmp_path / "pyr")
    cfg = ti.InverseConfig(resolution=(8, 8), spp=8, learning_rate=0.08,
                           seed=5, views_per_step=2, checkpoint_dir=ck,
                           checkpoint_every=2)
    stats = {}
    d_full, losses = ti.run_inverse_pyramid(targets, views, albedo, spec,
                                            settings, cfg, levels,
                                            device="cpu", stats=stats)
    assert [len(l) for l in losses] == [2, 4]
    assert len(stats["levels"]["8^3"]["step_s"]) == 4
    for f in sorted(os.listdir(os.path.join(ck, "L8"))):
        if int(f[len("step_"):-len(".npz")]) > 2:
            os.remove(os.path.join(ck, "L8", f))
    d_res, losses_res = ti.run_inverse_pyramid(targets, views, albedo, spec,
                                               settings, cfg, levels,
                                               resume=True, device="cpu")
    assert losses_res == [[], losses[1][2:]]
    np.testing.assert_array_equal(d_res.numpy(), d_full.numpy())


def test_spp_chunks_must_divide():
    spec, cam, _, density, albedo = jax_setup()
    tspec, _, tsettings = port_args(spec, cam)
    cams = ti.orbit_camera_specs(2, radius=100.0, res=(8, 8))
    cfg = ti.InverseConfig(resolution=(8, 8), spp=8, spp_chunks=3, n_steps=1)
    with pytest.raises(ValueError, match="spp_chunks"):
        ti.run_inverse_views(np.zeros((2, 8, 8, 3), np.float32), cams,
                             density, albedo, tspec, tsettings, cfg,
                             device="cpu")


def test_spp_chunks_split_the_samples():
    """Two chunks of half the samples: one forward and backward each per
    view, the grads averaged over views x chunks."""
    spec, cam, _, density, albedo = jax_setup()
    tspec, _, tsettings = port_args(spec, cam)
    cams = ti.orbit_camera_specs(2, radius=100.0, res=(8, 8), fov_x_deg=0.4)
    cfg = ti.InverseConfig(resolution=(8, 8), spp=8, spp_chunks=2, n_steps=2,
                           views_per_step=2, learning_rate=0.05)
    stats = {}
    d, losses, opt = ti.run_inverse_views(
        np.zeros((2, 8, 8, 3), np.float32), cams, density, albedo, tspec,
        tsettings, cfg, device="cpu", stats=stats)
    assert len(stats["program_s"]) == 2 * 2 * 2 and len(losses) == 2
    assert opt.count == 2 and np.isfinite(losses).all()
    assert float(d.max()) <= 1.0 and not np.array_equal(d.numpy(), density)


@pytest.mark.parametrize("n", [8, 6])
def test_upsample_density_matches_jax_resize(n):
    d = np.random.RandomState(n).rand(n, n, n).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(d), (2 * n,) * 3,
                                       method="trilinear"))
    got = ti.upsample_density(torch.tensor(d), (2 * n,) * 3).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_observability_matches_jax_exactly():
    gt = jproc.medical_volume((32, 32, 32), n_blobs=40)
    np.testing.assert_array_equal(procedural.medical_volume((32, 32, 32),
                                                            n_blobs=40), gt)
    np.testing.assert_array_equal(ti.observability_depth(gt, 100.0),
                                  ji.observability_depth(gt, 100.0))
    tau = ji.observability_depth(gt, 100.0)
    for rec in (np.full_like(gt, 0.25), np.where(tau < 5.0, gt, 0.25)):
        assert ti.split_mse_by_observability(rec, gt, 0.25, 100.0) == (
            ji.split_mse_by_observability(rec, gt, 0.25, 100.0))


def test_losses_match_jax_on_one_input():
    """The loss functions and the TV prior, same grids and seed."""
    spec, cam, settings, density, albedo = jax_setup()
    target = np.full((8, 8, 3), 0.3, np.float32)
    cams = view_cams()
    jcfg = ji.InverseConfig(resolution=(8, 8), spp=16, tv_weight=1e-2)
    tcfg = ti.InverseConfig(resolution=(8, 8), spp=16, tv_weight=1e-2)
    tspec, tcam, tsettings = port_args(spec, cam)
    tcams = [convert.camera_spec_from_jax(c) for c in cams]
    d, a = torch.tensor(density), torch.tensor(albedo)
    pairs = [
        (ji.make_loss_fn(spec, cam, settings, jcfg)(
            jnp.asarray(density), jnp.asarray(albedo), jnp.asarray(target), 3),
         ti.make_loss_fn(tspec, tcam, tsettings, tcfg)(d, a,
                                                       torch.tensor(target), 3)),
        (ji.make_multiview_loss_fn(spec, cams, settings, jcfg)(
            jnp.asarray(density), jnp.asarray(albedo),
            jnp.asarray(np.stack([target] * 2)), jnp.uint32(3)),
         ti.make_multiview_loss_fn(tspec, tcams, tsettings, tcfg)(
             d, a, torch.tensor(np.stack([target] * 2)), 3)),
        (ji._tv_loss(jnp.asarray(density)), ti._tv_loss(d)),
    ]
    for want, got in pairs:
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def test_entry_points_default_to_the_card():
    """Without a card the entry points raise instead of falling back."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    spec, cam, _, density, albedo = jax_setup()
    tspec, tcam, tsettings = port_args(spec, cam)
    cfg = ti.InverseConfig(resolution=(8, 8), spp=4, n_steps=1)
    targets = np.zeros((2, 8, 8, 3), np.float32)
    calls = (
        lambda: ti.run_inverse(targets[0], density, albedo, tspec, tcam,
                               tsettings, cfg),
        lambda: ti.run_inverse_views(targets, [tcam, tcam], density, albedo,
                                     tspec, tsettings, cfg),
        lambda: ti.run_inverse_pyramid(targets, [tcam, tcam], albedo, tspec,
                                       tsettings, cfg, [(4, 1)]),
        lambda: ti.render_view_targets(density, albedo, tspec, [tcam],
                                       tsettings, (8, 8), 4, False),
    )
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
