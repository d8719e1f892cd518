"""The CUDA kernels on the card (the fastSK tail kernel and the brickSK
tracking kernel): each against its plain torch version, the white
furnace through it, its launch count and its input checks.

These tests need a CUDA card and skip without one.  This file imports no
jax, so on a machine with a card and no jax it runs on its own:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

It also holds the kernel-input helper that tests/test_torch_tailpk.py
uses against the JAX kernel.
"""

import numpy as np
import pytest
import torch

from cudavolumerenderer_tpu_torch.models import brick, fast
from cudavolumerenderer_tpu_torch.ops import tailpk, tracking
from cudavolumerenderer_tpu_torch.ops.camera import make_camera
from cudavolumerenderer_tpu_torch.scene import procedural
from cudavolumerenderer_tpu_torch.scene import types

torch.set_num_threads(2)

RTOL, ATOL = 1e-5, 1e-6


def odd_scene(device="cpu"):
    """Random density on an odd 20x33x17 grid, a non-cube box, an affine
    albedo (A = (1, 0, -1), B = (0, 0.5, 1)) and anisotropy g = 0.3."""
    d = np.random.RandomState(2).rand(20, 33, 17).astype(np.float32)
    albedo = np.stack([d, 0.5 * np.ones_like(d), 1.0 - d], -1)
    medium = types.make_medium(
        d, albedo, box_min=(-0.5, -0.4, -0.6), box_max=(0.6, 0.5, 0.4),
        scale=20.0, max_density=1.0, g=0.3, device=device,
    )
    return types.make_scene(medium)


def kernel_inputs(n_paths, seed, device="cpu", max_path=6, rr=True):
    """(tab, brick, params, f, i, rng) for n_paths valid random paths."""
    scene = odd_scene(device)
    settings = types.RenderSettings.from_flags(
        True, russian_roulette=rr, max_path_length=max_path
    )
    tables = tailpk.dilated_tail_bricks(scene.medium.density.data)
    params = fast.tail_params(scene, settings)
    brick, f, i, rng = tailpk.random_tail_state(tables, params, n_paths, seed)
    return tables.tab, brick, params, f, i, rng


def track_inputs(n_rows, seed, device):
    """(tables, row_brick, f, rng, status) for n_rows binned rows on the
    smoke grid of the brickSK slice, at its scale 800."""
    d = torch.tensor(procedural.smoke_volume((128, 128, 50)), device=device)
    tables, major = tracking.build_dilated_bricks(d)
    inputs = tracking.random_track_state(
        major, n_rows, seed=seed, scale=800.0, vox_per_unit=(127.0, 127.0, 49.0)
    )
    return (tables.reshape(-1, tracking.ROW), *inputs)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n_paths", [128, 4096])
def test_kernel_matches_plain_version(cuda, n_paths):
    inputs = kernel_inputs(n_paths, seed=21, device=cuda)
    launches = tailpk.KERNEL.launches
    got = tailpk.run_tail_steps(*inputs, n_steps=16)
    torch.cuda.synchronize()
    assert tailpk.KERNEL.launches == launches + 1
    want = tailpk.tail_steps(*inputs, n_steps=16)
    (gf, gi, gs), (wf, wi, ws) = (
        [x.cpu().numpy() for x in got], [x.cpu().numpy() for x in want]
    )
    agree = (gi == wi).all(axis=0) & (gs == ws)
    print(f"kernel paths differing from plain: {int((~agree).sum())}")
    assert agree.mean() >= 0.999
    np.testing.assert_allclose(gf[:, agree], wf[:, agree], rtol=RTOL, atol=ATOL)


@pytest.mark.cuda
def test_white_furnace_through_kernel(cuda):
    d = procedural.blob_volume((24, 24, 24), n_blobs=3)
    scene = types.make_scene(types.make_medium(d, 1.0, scale=8.0,
                                               max_density=1.0, device=cuda))
    settings = types.RenderSettings.from_flags(
        True, russian_roulette=False, max_path_length=200, bsdf_kind="null"
    )
    launches = tailpk.KERNEL.launches
    img, _ = fast.render_tile(
        scene, make_camera(6, 6, device=cuda), settings, (6, 6),
        torch.zeros(2, device=cuda), (6, 6), 2, 3, 0, two_level=True,
        tail_pallas=True, tail_pk_width=16, tail_pk_steps=8, min_width=32,
    )
    assert tailpk.KERNEL.launches > launches
    np.testing.assert_allclose(img.cpu().numpy(), 2.0, rtol=2e-5)


@pytest.mark.cuda
def test_wrapper_checks_inputs(cuda):
    tab, brick, params, f, i, rng = kernel_inputs(64, seed=3, device=cuda)
    with pytest.raises(ValueError, match="i must be"):
        tailpk.run_tail_steps(tab, brick, params, f, i.long(), rng, 4)
    with pytest.raises(ValueError, match="contiguous"):
        tailpk.run_tail_steps(tab, brick, params, f.T.contiguous().T, i, rng, 4)
    with pytest.raises(ValueError, match="on cuda"):
        tailpk.run_tail_steps(tab.cpu(), brick, params, f, i, rng, 4)


@pytest.mark.cuda
@pytest.mark.parametrize("n_rows, n_steps", [(8, 8), (1250, 8), (1250, 32)])
def test_tracking_kernel_matches_plain_version(cuda, n_rows, n_steps):
    inputs = track_inputs(n_rows, seed=n_rows + n_steps, device=cuda)
    launches = tracking.KERNEL.launches
    got = tracking.run_track_steps(*inputs, n_steps=n_steps)
    torch.cuda.synchronize()
    assert tracking.KERNEL.launches == launches + 1
    want = tracking.track_steps(*inputs, n_steps=n_steps)
    (gt, gs, gtap, gst), (wt, ws, wtap, wst) = (
        [x.cpu().numpy() for x in got], [x.cpu().numpy() for x in want]
    )
    agree = (gs == ws) & (gtap == wtap) & (gst == wst)
    print(f"tracking lanes differing from plain: {int((~agree).sum())}")
    assert agree.mean() >= 0.999
    np.testing.assert_allclose(gt[agree], wt[agree], rtol=RTOL, atol=ATOL)


@pytest.mark.cuda
def test_white_furnace_through_tracking_kernel(cuda):
    d = procedural.blob_volume((24, 24, 24), n_blobs=3)
    scene = types.make_scene(types.make_medium(d, 1.0, scale=8.0,
                                               max_density=1.0, device=cuda))
    settings = types.RenderSettings.from_flags(
        True, russian_roulette=False, bsdf_kind="null"
    )
    launches = tracking.KERNEL.launches
    img, _, rounds = brick.render_tile(
        scene, make_camera(16, 16, device=cuda), settings, (16, 16),
        torch.zeros(2, device=cuda), (16, 16), 2, 3, 0, with_stats=True,
    )
    assert tracking.KERNEL.launches == launches + rounds
    np.testing.assert_array_equal(img.cpu().numpy(), 2.0)


@pytest.mark.cuda
def test_tracking_wrapper_checks_inputs(cuda):
    tables, row_brick, f, rng, status = track_inputs(4, seed=3, device=cuda)
    run = tracking.run_track_steps
    with pytest.raises(ValueError, match="status must be"):
        run(tables, row_brick, f, rng, status.long(), 4)
    with pytest.raises(ValueError, match="contiguous"):
        run(tables, row_brick, f.transpose(1, 2).contiguous().transpose(1, 2),
            rng, status, 4)
    with pytest.raises(ValueError, match="on cuda"):
        run(tables.cpu(), row_brick, f, rng, status, 4)
