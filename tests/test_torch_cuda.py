"""The CUDA kernels on the card (the fastSK tail kernel, the brickSK
tracking kernel and the five gather kernels of the gather
microbenchmark): each against its plain torch version, the white
furnace through the render kernels, launch counts and input checks; for
the gathers also out-of-range indices, inputs not 16-byte aligned and
taa0 at 65,536 rows.

These tests need a CUDA card and skip without one.  This file imports no
jax, so on a machine with a card and no jax it runs on its own:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

It also holds the kernel-input helper that tests/test_torch_tailpk.py
uses against the JAX kernel.
"""

import numpy as np
import pytest
import torch

from cudavolumerenderer_tpu_torch.benchmarks import micro_pgather
from cudavolumerenderer_tpu_torch.models import brick, fast
from cudavolumerenderer_tpu_torch.ops import pgather, tailpk, tracking
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


# (table MB, N, S): the CPU tests' size and the benchmark's published one
GATHER_SIZES = {"small": (0.25, 4096, 4), "published": (67.0, 262144, 16)}


def gather_args(name, size, device, rep=0):
    """The gather benchmark's arguments for kernel `name` (see
    benchmarks/micro_pgather.kernel_args) on `device`."""
    mb, n, s = GATHER_SIZES[size]
    V = micro_pgather.table_rows(mb, s)
    table = torch.from_numpy(micro_pgather.make_table(V)).to(device)
    return micro_pgather.kernel_args(name, table, n, s, rep)


@pytest.mark.cuda
@pytest.mark.parametrize("size", sorted(GATHER_SIZES))
@pytest.mark.parametrize("name", pgather.NAMES)
def test_gather_kernel_matches_plain_version(cuda, name, size):
    args = gather_args(name, size, cuda)
    run, plain = pgather.WRAPPERS[name]
    launches = pgather.KERNELS[name].launches
    got = run(*args)
    torch.cuda.synchronize()
    assert pgather.KERNELS[name].launches == launches + 1
    assert torch.equal(got, plain(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("name", pgather.NAMES)
def test_gather_wrapper_checks_inputs(cuda, name):
    tab, idx, *rest = gather_args(name, "small", cuda)
    run = pgather.WRAPPERS[name][0]
    with pytest.raises(ValueError, match="idx must be"):
        run(tab, idx.long(), *rest)
    with pytest.raises(ValueError, match="contiguous"):
        run(tab, idx.transpose(0, -1).contiguous().transpose(0, -1), *rest)
    with pytest.raises(ValueError, match="on cuda"):
        run(tab.cpu(), idx, *rest)


@pytest.mark.cuda
@pytest.mark.parametrize("name", pgather.NAMES)
def test_graph_replayed_loop_equals_eager_loop(cuda, name):
    """The benchmark's timed call: a CUDA graph captured over an INNER
    loop of launches, replayed on fresh indices, gives the eager loop's
    result, and each replay counts INNER launches."""
    inner = 4
    run = pgather.WRAPPERS[name][0]
    first, fresh = (gather_args(name, "small", cuda, rep) for rep in (0, 1))
    rest = first[2:]

    def loop(tab, idx):  # rolling along lanes keeps every index valid
        acc = torch.zeros(idx.shape, dtype=torch.float32, device=idx.device)
        for k in range(inner):
            acc = acc + run(tab, idx.roll(k, -1), *rest)
        return acc

    graphed = micro_pgather.GraphRun(loop, first[:2])
    launches = pgather.KERNELS[name].launches
    graphed.load(fresh[:2])
    got = graphed.run()
    torch.cuda.synchronize()
    assert pgather.KERNELS[name].launches == launches + inner
    assert torch.equal(got, loop(*fresh[:2]))


@pytest.mark.cuda
@pytest.mark.parametrize("name", pgather.NAMES)
def test_gather_kernel_fills_out_of_range_lanes(cuda, name):
    """An index outside the table reads nothing: stream gives 0 there (its
    masked shard takes), every other kernel NaN (jnp.take's fill).  The
    plain versions cannot take such indices, so the want is theirs on the
    valid indices with the fill put in."""
    tab, idx, *rest = gather_args(name, "small", cuda)
    want = pgather.WRAPPERS[name][1](tab, idx, *rest)
    bad = torch.zeros(idx.numel(), dtype=torch.bool, device=cuda)
    bad[::7] = True
    bad = bad.view(idx.shape)
    flat = idx.clone().view(-1)
    flat[::14] = -1
    flat[7::14] = 1 << 30
    fill = 0.0 if name == "stream" else float("nan")
    want = torch.where(bad, torch.full_like(want, fill), want)
    got = pgather.WRAPPERS[name][0](tab, flat.view(idx.shape), *rest)
    torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)


def at_4_byte_offset(x):
    """A contiguous copy of x whose storage starts 4 bytes past a 16-byte
    boundary."""
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    y = buf[1:].view(x.shape)
    y.copy_(x)
    assert y.is_contiguous() and y.data_ptr() % 16 != 0
    return y


@pytest.mark.cuda
@pytest.mark.parametrize("name", pgather.NAMES)
def test_gather_kernel_takes_unaligned_inputs(cuda, name):
    tab, idx, *rest = gather_args(name, "small", cuda)
    run, plain = pgather.WRAPPERS[name]
    want = plain(tab, idx, *rest)
    got = run(at_4_byte_offset(tab), at_4_byte_offset(idx), *rest)
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_taa0_takes_any_row_count(cuda):
    """R = 65,536 rows: past what one column of the old design's shared
    memory held (58,112)."""
    R = 65536
    gen = np.random.default_rng(9)
    tab = torch.from_numpy(gen.random((R, 128), dtype=np.float32)).to(cuda)
    idx = torch.from_numpy(
        gen.integers(0, R, (R, 128)).astype(np.int32)).to(cuda)
    launches = pgather.KERNELS["taa0"].launches
    got = pgather.run_taa0(tab, idx)
    torch.cuda.synchronize()
    assert pgather.KERNELS["taa0"].launches == launches + 1
    assert torch.equal(got, pgather.taa0_gather(tab, idx))
