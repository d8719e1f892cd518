"""The CUDA kernels on the card (the fastSK tail kernel, the brickSK
tracking kernel and the five gather kernels of the gather
microbenchmark): each against its plain torch version, the white
furnace through the render kernels, launch counts and input checks; for
the gathers also out-of-range indices, inputs not 16-byte aligned and
taa0 at 65,536 rows and taa1 at row counts no multiple of its rows per
block.  The scheduler family (naiveSK ... fastQ) renders on the card,
against the same render on the CPU, and its white furnace is exact
there.  The differentiable path
(no kernel of its own) gives the CPU's image and cotangents on the card,
and one run_inverse step the CPU's loss and grid.  The scene and camera
constructors build on the card by default, and fastSK's defer_ggx,
brick_major and 'split' table give the default render bit for bit there.
A rank of parallel/ takes the card by default, and a 1-rank NCCL
render_sharded equals fast.render_tile bit for bit.  fastSK's body kernels
(csrc/fastbody.cu) equal its eager body bit for bit per evaluation, per
stage and per render; render_diff's replay kernels (csrc/replaybody.cu)
equal the replay's eager body per evaluation (the primal, and pass B with
atomics or, under deterministic algorithms, bit for bit) and per stage,
and render_diff through them gives the eager body's image and
cotangents.  The integrator family's kernels (csrc/familybody.cu: bounce,
refill, extend and flush, the drain and the gated chains) equal the eager
functions bit for bit per launch at 65,536, 4,096, 24^2 and 40^2 lanes,
every row through them gives the eager row's n_rays and evaluations and
its image to float-summation order, and the white furnace is exact
through each.  brickSK's round kernels (csrc/brickbody.cu: phase A and
the tracking round) equal their plain versions bit for bit in every lane
field at 1,920 and 160,000 lanes, with two lanes per pixel and on a
'full' albedo grid, on rounds kept from a render; a render through them
equals the eager loop's (image, n_rays, rounds), and the white furnace is
exact through them.  Under the variable boundary the family's bounce (the
isosurface march in csrc/familybody.cu) equals bounce_step bit for bit per
launch and through the drain at 24^2 and 40^2 lanes, each marching row
through the kernels gives the eager row's n_rays and evaluations, and the
furnace stays exact.  fastQ's kernels (csrc/fastqbody.cu) equal its eager
body bit for bit per iteration (a refill, a periodic flush, a step, an
iteration past the queue) and through the drain (also relaunched at a
lowered cap), at 24^2 and 40^2 lanes, one- and two-level; a render through
them gives the eager loop's n_rays, n_iters and n_busy bit for bit on a
constant, an affine and a 'full' albedo, and the furnace is exact.
fastSK's tail stage as one drain (csrc/tailpk.cu's
drain_kernel) equals its eager loop bit for bit in every lane field and
counter at pools of 128 and 40 lanes, with RR on and off, GGX and the null
boundary, a constant and an affine albedo, and through its relaunch at a
lowered cap; a render through it equals the render through the eager loop.
render_diff's bounce-lockstep replays (csrc/nestedreplay.cu: one-level and
the nested two-level) equal the eager loop in every lane field at 24^2 and
40^2 lanes, pass A and pass B, their cotangents within GRAD_* with atomics
and bit for bit under deterministic algorithms; the white furnace is exact
through pass A, and the one-level backward never reaches the eager loop.
fastSK's body kernels in their speculative mode (spec_k 2, 8 and 32, one-
and two-level, f32, packed-4 and 'split' tables) and their deferred GGX
flush (defer_ggx 1 and 4, GGX and null, one tile and multi-tile) equal the
eager body bit for bit per evaluation, per stage (gated and drained) and
per render at 24^2 and 40^2, and the white furnace is exact through each
mode.

These tests need a CUDA card and skip without one.  This file imports no
jax, so on a machine with a card and no jax it runs on its own:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

It also holds the kernel-input helper that tests/test_torch_tailpk.py
uses against the JAX kernel.
"""

import functools

import numpy as np
import pytest
import torch

from cudavolumerenderer_tpu_torch.benchmarks import micro_pgather
from cudavolumerenderer_tpu_torch.config import Config, Kernel
from cudavolumerenderer_tpu_torch.models import (
    brick, differentiable, fast, inverse,
)
from cudavolumerenderer_tpu_torch.models.renderer import make_kernel_fn
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


def thin_inputs(n_paths, seed, device="cpu", rr=True):
    """(tab, brick, params, f, i, rng) for paths in a thin medium under a
    high majorant: density 0.02 with a 1.0 spike at every brick corner,
    scale 300, so ~150 flights cross a brick and ~2% of taps accept: runs
    of 32 and more null collisions."""
    d = np.full((33, 33, 33), 0.02, np.float32)
    d[::16, ::16, ::16] = 1.0
    scene = types.make_scene(types.make_medium(
        d, 0.8, scale=300.0, max_density=1.0, g=0.3, device=device))
    settings = types.RenderSettings.from_flags(
        True, russian_roulette=rr, max_path_length=1000)
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
@pytest.mark.parametrize("medium", ["dense", "thin"])
@pytest.mark.parametrize("n_steps", [1, 16, 40])
@pytest.mark.parametrize("n_paths", [1, 31, 128, 4096])
def test_kernel_matches_plain_version(cuda, n_paths, n_steps, medium):
    """The dense medium scatters and exits within a few steps; in the thin
    one K = 40 takes two lookahead rounds (32 + 8 steps) with no event.
    R = 1 and 31 leave a block's second warp without a path."""
    make = kernel_inputs if medium == "dense" else thin_inputs
    inputs = make(n_paths, seed=21, device=cuda)
    launches = tailpk.KERNEL.launches
    got = tailpk.run_tail_steps(*inputs, n_steps=n_steps)
    torch.cuda.synchronize()
    assert tailpk.KERNEL.launches == launches + 1
    want = tailpk.tail_steps(*inputs, n_steps=n_steps)
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
    from cudavolumerenderer_tpu_torch.ops import taildrain

    # the tail stage runs as one drain launch; eager_body=True runs its
    # eager loop, which launches the tail kernel once a round
    for eager in (False, True):
        launches = tailpk.KERNEL.launches, taildrain.KERNEL.drain_launches
        img, _ = fast.render_tile(
            scene, make_camera(6, 6, device=cuda), settings, (6, 6),
            torch.zeros(2, device=cuda), (6, 6), 2, 3, 0, two_level=True,
            tail_pallas=True, tail_pk_width=16, tail_pk_steps=8,
            min_width=32, eager_body=eager,
        )
        if eager:
            assert tailpk.KERNEL.launches > launches[0]
        else:
            assert taildrain.KERNEL.drain_launches == launches[1] + 1
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
    # the eager loop launches the tracking kernel once a round (the default
    # path runs csrc/brickbody.cu's round kernel instead)
    img, _, rounds = brick.render_tile(
        scene, make_camera(16, 16, device=cuda), settings, (16, 16),
        torch.zeros(2, device=cuda), (16, 16), 2, 3, 0, with_stats=True,
        eager_body=True,
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


# (name, case) of the tile kernel's ragged shapes: binned with K = 128 and
# 16,256 lanes per shard (a ragged last tile in every shard) and on a
# 320 MB table (S = 16: 21 MB shards, the table past the 50 MB L2); vmem on
# a table of no whole number of tiles with n = 262,148 (16-byte path, a
# last tile of 4 lanes) and n = 262,147 (scalar path)
TILE_CASES = [("binned", "K128"), ("binned", "K16256"), ("binned", "320MB"),
              ("vmem", "ragged"), ("vmem", "ragged_scalar")]


def tile_case_args(name, case, device, rep=0):
    gen = np.random.default_rng(rep + 11)
    if name == "binned":
        S, K = {"K128": (16, 128), "K16256": (16, 16256),
                "320MB": (16, 16384)}[case]
        V = (micro_pgather.table_rows(320.0, S) if case == "320MB"
             else S * 3000)
        tab = torch.from_numpy(gen.random(V, dtype=np.float32)).to(device)
        idx = micro_pgather.fresh_binned(rep, S, K, V // S)
        return tab, torch.from_numpy(idx).to(device).view(S, K // 128, 128)
    V = micro_pgather.VMEM_ENTRIES - 100
    n = 262148 if case == "ragged" else 262147
    tab = torch.from_numpy(gen.random(V, dtype=np.float32)).to(device)
    return tab, torch.from_numpy(micro_pgather.fresh_idx(rep, n, V)).to(device)


GATHER_CASES = [(name, size) for size in sorted(GATHER_SIZES)
                for name in pgather.NAMES] + TILE_CASES


@pytest.mark.cuda
@pytest.mark.parametrize("name, size", GATHER_CASES,
                         ids=[f"{size}-{name}" for name, size in GATHER_CASES])
def test_gather_kernel_matches_plain_version(cuda, name, size):
    args = (gather_args(name, size, cuda) if size in GATHER_SIZES
            else tile_case_args(name, size, cuda))
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
@pytest.mark.parametrize("name", ["vmem", "binned"])
def test_tile_kernel_graph_replay_equals_eager(cuda, name):
    """A CUDA graph of 16 calls of the tile kernel at the published shapes,
    captured on one index set and replayed on 16 fresh ones (the
    ring and the persistent grid hold no state between calls), gives
    the eager calls' outputs on those indices."""
    run = pgather.WRAPPERS[name][0]
    sets = [gather_args(name, "published", cuda, rep) for rep in range(17)]
    tab = sets[0][0]
    static = [a[1].clone() for a in sets[:16]]
    graphed = micro_pgather.GraphRun(
        lambda *idx: [run(tab, i) for i in idx], static)
    graphed.load([a[1] for a in sets[1:]])
    got = graphed.run()
    torch.cuda.synchronize()
    for out, (_, idx) in zip(got, sets[1:]):
        assert torch.equal(out, run(tab, idx))


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
@pytest.mark.parametrize("R", [1, 3, 2049, 20001])
@pytest.mark.parametrize("aligned", [True, False])
def test_taa1_takes_any_row_count(cuda, R, aligned):
    """One warp per row in blocks of 8: 1, 3 and 2,049 rows are no
    multiple of the rows per block; 20,001 rows are more than one wave
    of warps, so warps walk several rows.  Unaligned inputs take the
    scalar path."""
    gen = np.random.default_rng(R)
    tab = torch.from_numpy(gen.random((R, 128), dtype=np.float32)).to(cuda)
    idx = torch.from_numpy(
        gen.integers(0, 128, (R, 128)).astype(np.int32)).to(cuda)
    want = pgather.taa1_gather(tab, idx)
    if not aligned:
        tab, idx = at_4_byte_offset(tab), at_4_byte_offset(idx)
    launches = pgather.KERNELS["taa1"].launches
    got = pgather.run_taa1(tab, idx)
    torch.cuda.synchronize()
    assert pgather.KERNELS["taa1"].launches == launches + 1
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


# make_kernel_fn rows of the scheduler family (Config fields beside kernel)
SCHEDULERS = [
    ("naiveSK", {}), ("naiveMK", {}),
    ("regenerationSK", {"regeneration_level": 0}),
    ("regenerationSK", {"regeneration_level": 1}),
    ("regenerationSK", {"regeneration_level": 2}),
    ("streamingSK", {}), ("sortingSK", {}), ("streamingMK", {}),
    ("fastQ", {}), ("fastQ", {"two_level": True}),
]


def scheduler_render(kernel, fields, device, albedo=None, settings=None):
    """A 16^2 x 2 render of the blob 32^3 scene through make_kernel_fn's
    row: (image / spp on the host, n_rays)."""
    d = procedural.blob_volume()
    if albedo is None:
        albedo = np.stack([d, 0.5 * np.ones_like(d), 1.0 - d], -1)
    scene = types.make_scene(types.make_medium(d, albedo, scale=40.0,
                                               max_density=1.0, device=device))
    settings = settings or types.RenderSettings.from_flags(True)
    fn = make_kernel_fn(Config(kernel=Kernel.from_name(kernel), n_lanes=256,
                               **fields))
    img, n_rays = fn(scene, make_camera(16, 16, device=device), settings,
                     (16, 16), torch.zeros(2, device=device), (16, 16), 2, 9, 0)
    assert img.device.type == torch.device(device).type  # no fallback
    return img.cpu().numpy() / 2, float(n_rays)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel, fields", SCHEDULERS)
def test_scheduler_on_card_matches_cpu(cuda, kernel, fields):
    """CUDA's and the CPU's float32 math differ in the last bits, so a
    path may take another branch: the same estimate, mostly the same
    pixels."""
    a, ra = scheduler_render(kernel, fields, cuda)
    b, rb = scheduler_render(kernel, fields, "cpu")
    assert np.isfinite(a).all()
    assert abs(ra - rb) <= 0.01 * rb
    assert abs(a.mean() - b.mean()) < 0.02
    assert np.mean(np.abs(a - b) < 1e-4) > 0.5


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["naiveSK", "streamingSK", "fastQ"])
def test_scheduler_white_furnace_on_card(cuda, kernel):
    settings = types.RenderSettings.from_flags(True, bsdf_kind="null")
    img, _ = scheduler_render(kernel, {}, cuda, albedo=1.0, settings=settings)
    assert np.array_equal(img, np.ones_like(img))


def diff_render(device, bsdf, two_level):
    """render_diff on a random 16^3 grid with a per-voxel albedo at
    16^2 x 4, and its cotangents under a random image cotangent."""
    rs = np.random.RandomState(0)
    density = torch.tensor((rs.rand(16, 16, 16) * 0.8).astype(np.float32),
                           device=device, requires_grad=True)
    albedo = torch.tensor((0.3 + 0.6 * rs.rand(16, 16, 16, 4))
                          .astype(np.float32), device=device,
                          requires_grad=True)
    g_img = torch.tensor(rs.rand(16, 16, 3).astype(np.float32), device=device)
    settings = types.RenderSettings.from_flags(
        True, russian_roulette=False, max_path_length=16, bsdf_kind=bsdf)
    img = differentiable.render_diff(
        density, albedo, 7, differentiable.SceneSpec(scale=4.0),
        differentiable.CameraSpec(res_x=16, res_y=16, fov_x_deg=0.5), settings,
        (16, 16), 4, two_level)
    img.backward(g_img)
    assert img.device.type == torch.device(device).type  # no fallback
    return [x.detach().cpu().numpy() for x in (img, density.grad, albedo.grad)]


@pytest.mark.cuda
@pytest.mark.parametrize("two_level", [False, True], ids=["one-level",
                                                          "two-level"])
@pytest.mark.parametrize("bsdf", ["null", "ggx"])
def test_render_diff_on_card_matches_cpu(cuda, bsdf, two_level):
    """The image allclose at 1e-4 on the null scene (>= 90% of pixels on
    the GGX scene, where the last bits of CUDA's float32 math send a path
    down another branch); both cotangents within rtol 1e-3, atol 1e-4 x
    max on >= 99% of voxels (the adjoints add with atomics), their sums
    within 1e-3 on the null scene and 1e-2 on the GGX scene (one path of
    1,024 carries ~1e-3 of a sum)."""
    (ci, cdd, cda), (pi, pdd, pda) = (diff_render(dev, bsdf, two_level)
                                      for dev in (cuda, "cpu"))
    sum_tol = 1e-3 if bsdf == "null" else 1e-2
    for got, want in ((cdd, pdd), (cda, pda)):
        assert np.isfinite(got).all()
        assert abs(got.sum() - want.sum()) <= sum_tol * np.abs(want).sum()
        assert np.isclose(got, want, rtol=1e-3,
                          atol=1e-4 * np.abs(want).max()).mean() >= 0.99
    if bsdf == "null":
        np.testing.assert_allclose(ci, pi, rtol=1e-4, atol=1e-4)
    else:
        assert np.all(np.isclose(ci, pi, rtol=1e-4, atol=1e-4), -1).mean() >= 0.9


@pytest.mark.cuda
def test_run_inverse_step_on_card(cuda):
    """One Adam step of run_inverse on a 6^3 grid: the card's loss and
    grid against the CPU's."""
    rs = np.random.RandomState(0)
    density = (0.3 + 0.4 * rs.rand(6, 6, 6)).astype(np.float32)
    albedo = np.zeros((6, 6, 6, 4), np.float32)
    spec = differentiable.SceneSpec(scale=2.5, max_density=1.0)
    cam = differentiable.CameraSpec(res_x=8, res_y=8, fov_x_deg=0.4)
    settings = types.RenderSettings.from_flags(
        True, russian_roulette=False, max_path_length=8, bsdf_kind="null")
    target = np.full((8, 8, 3), 0.3, np.float32)
    config = inverse.InverseConfig(resolution=(8, 8), spp=32,
                                   learning_rate=0.05, n_steps=1)
    runs = [inverse.run_inverse(target, density, albedo, spec, cam, settings,
                                config, device=dev) for dev in (cuda, "cpu")]
    (d_card, _, l_card), (d_cpu, _, l_cpu) = runs
    assert d_card.device.type == "cuda"
    np.testing.assert_allclose(l_card, l_cpu, rtol=1e-4)
    np.testing.assert_allclose(d_card.cpu().numpy(), d_cpu.numpy(), atol=1e-4)
    assert not np.array_equal(d_cpu.numpy(), density)


@pytest.mark.cuda
def test_constructors_default_to_card(cuda):
    """make_camera, make_camera_look_at, make_medium and
    CameraController.camera build on the card unless asked for the CPU."""
    from cudavolumerenderer_tpu_torch.ops.camera import make_camera_look_at
    from cudavolumerenderer_tpu_torch.ops.camera_controller import (
        CameraController,
    )

    cams = [make_camera(8, 8),
            make_camera_look_at((0, 0, 100), (0, 0, 0), (0, 1, 0), 8, 8, 0.7),
            CameraController(8, 8).camera()]
    for c in cams:
        assert c.inv_view.device.type == c.raster_to_view.device.type == "cuda"
    medium = types.make_medium(np.ones((4, 4, 4), np.float32), 0.9)
    assert all(t.device.type == "cuda" for t in (
        medium.density.data, medium.albedo.data, medium.box_min, medium.scale))
    assert make_camera(8, 8, device="cpu").inv_view.device.type == "cpu"


def fast_option_render(device, option, shape=(16, 16, 128), albedo=None):
    """A 24^2 x 4 two-level fastSK render in pools of 576, 512 and 256
    lanes (image, n_rays) on the host."""
    d = procedural.blob_volume(shape[::-1], n_blobs=3)
    if albedo is None:
        albedo = np.stack([d, 0.5 * np.ones_like(d), 1.0 - d], -1)
    scene = types.make_scene(types.make_medium(d, albedo, scale=20.0,
                                               max_density=1.0, device=device))
    img, n_rays = fast.render_tile(
        scene, make_camera(24, 24, device=device),
        types.RenderSettings.from_flags(True), (24, 24),
        torch.zeros(2, device=device), (24, 24), 4, 7, 0, two_level=True,
        cascade_factor=2, min_width=256, **option)
    assert img.device.type == torch.device(device).type
    return img.cpu().numpy(), float(n_rays)


@pytest.mark.cuda
@pytest.mark.parametrize("option", [dict(defer_ggx=4), dict(brick_major=True)],
                         ids=["defer_ggx", "brick_major"])
def test_fast_option_bit_equal_on_card(cuda, option):
    """defer_ggx re-times boundary events and brick_major re-lays the
    table ((16, 16, 128) divides its bricks): on the card both give the
    default render bit for bit, through the GGX boundary.  Both run
    through the body kernels: defer_ggx's flush runs in them."""
    from cudavolumerenderer_tpu_torch.ops import fastbody

    deferred = fastbody.KERNEL.by_mode["defer"]
    launches = fastbody.KERNEL.launches + fastbody.KERNEL.drain_launches
    a, ra = fast_option_render(cuda, option)
    assert (fastbody.KERNEL.launches + fastbody.KERNEL.drain_launches
            > launches)
    assert (fastbody.KERNEL.by_mode["defer"] > deferred) == (
        "defer_ggx" in option)
    b, rb = fast_option_render(cuda, {})
    assert np.isfinite(a).all() and ra > 0
    np.testing.assert_array_equal(a, b)
    assert ra == rb


@pytest.mark.cuda
def test_split_equals_full_on_card(cuda, monkeypatch):
    """A per-voxel albedo sent to 'split' by a small budget renders the
    'full' table's image bit for bit on the card."""
    from cudavolumerenderer_tpu_torch.utils import occupancy

    shape = (16, 16, 32)
    alb = np.random.default_rng(4).uniform(0.3, 1.0, shape + (3,))
    alb = alb.astype(np.float32)
    b, rb = fast_option_render(cuda, dict(tail_spec=4), shape, alb)
    monkeypatch.setattr(occupancy, "device_memory_budget",
                        lambda device=None: 40 * int(np.prod(shape)))
    a, ra = fast_option_render(cuda, dict(tail_spec=4), shape, alb)
    np.testing.assert_array_equal(a, b)
    assert ra == rb


@pytest.mark.cuda
def test_ranks_default_to_the_card_and_need_a_group(cuda):
    """A rank's device is the card by default; make_mesh raises until a
    process group exists."""
    import torch.distributed as dist

    from cudavolumerenderer_tpu_torch.parallel import mesh

    assert mesh.rank_device().type == "cuda"
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="initialize_distributed"):
        mesh.make_mesh()


@pytest.mark.cuda
def test_one_rank_nccl_render_sharded_equals_render_tile(cuda):
    """A 1-rank NCCL group (the backend a CUDA device gets by default):
    render_sharded renders every sample on its rank, so its image and
    n_rays equal fast.render_tile's bit for bit at 64^2."""
    import socket

    import torch.distributed as dist

    from cudavolumerenderer_tpu_torch.parallel import mesh as pm
    from cudavolumerenderer_tpu_torch.parallel.shard import render_sharded

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dev = pm.initialize_distributed(
        init_method=f"tcp://127.0.0.1:{port}", world_size=1, rank=0)
    try:
        assert dev.type == "cuda" and dist.get_backend() == "nccl"
        m = pm.make_mesh(1)
        assert m.device == dev
        scene = odd_scene(m.device)
        camera = make_camera(64, 64, device=m.device)
        settings = types.RenderSettings.from_flags(True)
        kw = dict(two_level=True, table_bits=4, cascade_factor=1.25)
        img, n_rays = render_sharded(scene, camera, settings, (64, 64), 5, 3,
                                     m, kernel="fast", **kw)
        want, want_rays = fast.render_tile(
            scene, camera, settings, (64, 64), torch.zeros(2, device=dev),
            (64, 64), 5, 3, 0, **kw)
        assert img.device == dev and float(n_rays) > 0
        np.testing.assert_array_equal(img.cpu().numpy(), want.cpu().numpy())
        assert float(n_rays) == float(want_rays)
    finally:
        dist.destroy_process_group()


# -- the fastSK body kernel (csrc/fastbody.cu) --------------------------------

def body_scene(device, albedo="affine", shape=(24, 24, 24), scale=20.0,
               g=0.3, tail_free=False):
    """A medical-like blob volume with an affine, constant or per-voxel
    ('full') albedo and HG anisotropy g."""
    d = procedural.medical_volume(shape, n_blobs=4).astype(np.float32)
    if albedo == "affine":
        alb = np.stack([d, 0.5 * np.ones_like(d), 1.0 - d], -1)
    elif albedo == "const":
        alb = 0.8
    else:
        alb = np.random.default_rng(5).uniform(0.3, 1.0, shape + (3,))
        alb = alb.astype(np.float32)
    return types.make_scene(types.make_medium(
        d, alb, scale=scale, max_density=1.0, g=g, device=device))


#: (id, scene keywords, settings keywords, render_tile keywords): every mode
#: the kernel covers, each in a cascade of several pools (min_width 256) so
#: the tail pools' chained evaluations run too
BODY_CASES = [
    ("f32-2l-ggx", {}, {}, dict(two_level=True)),
    ("f32-1l-ggx", {}, {}, dict(two_level=False)),
    ("null-2l", {}, dict(bsdf_kind="null"), dict(two_level=True)),
    ("null-1l", {}, dict(bsdf_kind="null"), dict(two_level=False)),
    ("rr-off-cap", {}, dict(russian_roulette=False, max_path_length=4),
     dict(two_level=True)),
    ("heitz-2l", {}, dict(mitsuba_comparable=False), dict(two_level=True)),
    ("const-albedo", dict(albedo="const"), {}, dict(two_level=True)),
    ("full-2l", dict(albedo="full"), {}, dict(two_level=True)),
    ("full-1l", dict(albedo="full"), {}, dict(two_level=False)),
    ("packed8-2l", {}, {}, dict(two_level=True, table_bits=8)),
    ("packed4-1l", {}, {}, dict(two_level=False, table_bits=4)),
    ("packed4-2l", {}, {}, dict(two_level=True, table_bits=4)),
    ("brick-major-2l", dict(shape=(16, 16, 128)), {},
     dict(two_level=True, brick_major=True)),
    ("brick-major-packed", dict(shape=(16, 16, 128)), {},
     dict(two_level=True, brick_major=True, table_bits=4)),
    ("tail-bricks", {}, {}, dict(two_level=True, tail_bricks=4)),
    ("tail-single-level", {}, {},
     dict(two_level=True, tail_single_level=True)),
    ("m2", {}, {}, dict(two_level=True, lanes_per_pixel=2)),
    ("g0", dict(g=0.0), {}, dict(two_level=True)),
    # 40 and 24 are no powers of two: the pixel row and the raster scale
    # divide by them (on the card a multiplication by the reciprocal)
    ("res40-2l", {}, {}, dict(two_level=True, res=40)),
    ("res24-1l", {}, {}, dict(two_level=False, res=24)),
    # --champion's knobs (q4 tables, 512 bricks, cascade 1.25, min_width
    # 64): six pools from 2,304 lanes
    ("champion", {}, {}, dict(two_level=True, res=48, table_bits=4,
                              max_bricks=512, cascade_factor=1.25,
                              min_width=64)),
    # micro_smoke2's brick_size overrides (pick_brick's list bypassed; the
    # kernel reads the brick counts at run time) and micro_ablate's GGX
    # with RR off (paths end at the box or at max_path_length)
    *((f"brick{''.join(map(str, b))}-res{r}", {}, {},
       dict(two_level=True, brick_size=b, res=r))
      for b in ((2, 2, 2), (2, 2, 4), (8, 8, 8)) for r in (24, 40)),
    *((f"ggx-rr-off-{lv}-res{r}", {}, dict(russian_roulette=False),
       dict(two_level=lv == "2l", res=r))
      for lv in ("1l", "2l") for r in (24, 40)),
]


def body_render(device, scene, settings, res=32, spp=4, multi=False, **kw):
    """with_stats fastSK render of `scene` on `device` (a 2x2 multi-tile
    cascade of res/2 tiles with multi), in pools of cascade factor 2 down
    to 256 lanes unless kw names others."""
    cam = make_camera(res, res, device=device)
    kw = {"cascade_factor": 2, "min_width": 256, **kw}
    if multi:
        h = res // 2
        off = torch.tensor([[0, 0], [h, 0], [0, h], [h, h]],
                           dtype=torch.float32, device=device)
        bases = torch.arange(4, dtype=torch.int64, device=device) * (h * h * spp)
        return fast.render_tile(scene, cam, settings, (h, h), off, (res, res),
                                spp, 11, bases, with_stats=True, **kw)
    return fast.render_tile(
        scene, cam, settings, (res, res), torch.zeros(2, device=device),
        (res, res), spp, 11, 3, with_stats=True, **kw)


def assert_same_render(a, b):
    """image, n_rays, n_rows, n_busy and the per-stage rows bit for bit"""
    for x, y in zip(a, b):
        assert torch.equal(x, y), (x, y) if x.numel() < 8 else "image"


def state_mismatches(a, b):
    """Fields of two FastStates that differ (NaN equal to NaN), with their
    differing lane counts."""
    out = {}
    for name in a._fields:
        x, y = getattr(a, name), getattr(b, name)
        if name == "rng":
            x, y = torch.stack([x.state, x.inc]), torch.stack([y.state, y.inc])
        same = (x == y) | (torch.isnan(x) & torch.isnan(y)) if (
            x.is_floating_point()) else x == y
        if not bool(same.all()):
            out[name] = int((~same).reshape(x.shape[0], -1).any(-1).sum()
                            if x.ndim else 1)
    return out


def clone_state(s):
    return type(s)(*(
        type(v)(v.state.clone(), v.inc.clone()) if hasattr(v, "inc")
        else v.clone() for v in s))


def checked_stages(bad: list, modes: list):
    """A stand-in for ops.fastbody.run_stage that first runs the stage as
    the per-evaluation loop (fastbody.loop_stage, each kernel evaluation
    held against one eager evaluation of the same state and its pending
    count) on a copy of the state, then the stage path on the state, and
    records in `bad` where either differs (every FastState field, the
    counters and the stage's evaluations included) and in `modes` the
    stage's mode."""
    from cudavolumerenderer_tpu_torch.ops import fastbody

    run_stage, run_body = fastbody.run_stage, fastbody.run_body

    def checked_body(ctx, s, out=None):
        want = ctx.plain(clone_state(s))
        got, pending = run_body(ctx, s, out)
        diff = state_mismatches(got, want)
        if diff:
            bad.append(("evaluation", s.alive.shape[0], diff))
        pend = int((want.alive | (want.samples_done < int(
            ctx.iparams[fastbody.IP_SPP]))).sum())
        assert int(pending) == pend
        return got, pending

    def stage(ctx, s, thresh, k_chain, last):
        fastbody.run_body = checked_body
        try:
            want, n_want = fastbody.loop_stage(ctx, clone_state(s), thresh,
                                               k_chain)
        finally:
            fastbody.run_body = run_body
        got, n = run_stage(ctx, s, thresh, k_chain, last)
        diff = state_mismatches(got, want)
        if diff or n != n_want:
            bad.append(("stage", thresh, diff, n, n_want))
        modes.append(fastbody.stage_mode("cuda", 1, thresh))
        return got, n

    return stage


@pytest.mark.cuda
@pytest.mark.parametrize("case", BODY_CASES, ids=[c[0] for c in BODY_CASES])
def test_body_kernel_equals_eager_body(cuda, case):
    """Every stage through run_stage (gated chains, and the drain for the
    last stage) equals the per-evaluation loop on the same state in every
    FastState field and counter, every evaluation of that loop equals the
    eager body's on the same state, and the whole render (image, rays,
    rows, busy lanes, per-stage rows) equals the eager render bit for
    bit."""
    from cudavolumerenderer_tpu_torch.ops import fastbody

    _, scene_kw, settings_kw, kw = case
    scene = body_scene(cuda, **scene_kw)
    settings_kw = dict(settings_kw)
    settings = types.RenderSettings.from_flags(
        settings_kw.pop("mitsuba_comparable", True), **settings_kw)
    run = fastbody.run_stage
    bad, modes = [], []
    launches = fastbody.KERNEL.launches, fastbody.KERNEL.drain_launches
    fastbody.run_stage = checked_stages(bad, modes)
    try:
        got = body_render(cuda, scene, settings, **kw)
    finally:
        fastbody.run_stage = run
    assert fastbody.KERNEL.launches > launches[0]
    assert fastbody.KERNEL.drain_launches > launches[1]
    assert modes == ["gated"] * (len(modes) - 1) + ["drain"] and len(modes) > 1
    assert not bad, f"{len(bad)} evaluations or stages differ; first {bad[:3]}"
    want = body_render(cuda, scene, settings, eager_body=True, **kw)
    assert_same_render(got, want)
    assert float(got[1]) > 0 and torch.isfinite(got[0]).all()


def kept_stages(device, scene, settings, **kw):
    """A render through the stage path keeping, per stage, (ctx, a copy of
    its entry state, thresh, k_chain)."""
    from cudavolumerenderer_tpu_torch.ops import fastbody

    kept, run = [], fastbody.run_stage

    def keep(ctx, s, thresh, k_chain, last):
        kept.append((ctx, clone_state(s), thresh, k_chain))
        return run(ctx, s, thresh, k_chain, last)

    fastbody.run_stage = keep
    try:
        out = body_render(device, scene, settings, **kw)
    finally:
        fastbody.run_stage = run
    return kept, out


@pytest.mark.cuda
def test_drain_cap_and_block_sizes(cuda):
    """The drain on the last stage's state with caps of 1, 5 and the
    default, in blocks of 32, 64, 128 and 256 threads, equals the
    per-evaluation loop bit for bit; it launches ceil(L / cap) times (L
    the longest lane's evaluations), reads the host once per launch, and
    its evaluations E = k_chain * ceil(L / k_chain) are the loop's."""
    from cudavolumerenderer_tpu_torch.ops import fastbody

    scene = body_scene(cuda)
    settings = types.RenderSettings.from_flags(True)
    kept, _ = kept_stages(cuda, scene, settings, two_level=True)
    ctx, s, thresh, k_chain = kept[-1]
    assert thresh == 0
    width = s.alive.shape[0]
    want, n_want = fastbody.loop_stage(ctx, clone_state(s), 0, k_chain)
    evals = float(want.n_rows - s.n_rows) / width
    assert n_want == evals
    for cap in (1, 5, fastbody.DRAIN_CAP):
        for threads in (32, 64, 128, 256):
            reads = fastbody.KERNEL.reads
            got, n = fastbody.KERNEL.drain(ctx, clone_state(s), k_chain,
                                           cap=cap, threads=threads)
            assert not state_mismatches(got, want), (cap, threads)
            info = fastbody.KERNEL.last_drain
            assert n == info["E"] == evals == k_chain * -(-info["L"] // k_chain)
            assert info["launches"] == max(1, -(-info["L"] // cap))
            assert fastbody.KERNEL.reads - reads == info["launches"]


@pytest.mark.cuda
def test_gated_batches(cuda):
    """Gated chains on every stage with a threshold above 0, enqueued 1, 3
    and 32 evaluations per host read, equal the per-evaluation loop bit
    for bit; the host reads the control words once per batch and once at
    the start."""
    from cudavolumerenderer_tpu_torch.ops import fastbody

    scene = body_scene(cuda)
    settings = types.RenderSettings.from_flags(True)
    kept, _ = kept_stages(cuda, scene, settings, two_level=True,
                          tail_chain=4)
    gated = [k for k in kept if k[2] > 0]
    assert len(gated) >= 2
    for ctx, s, thresh, k_chain in gated:
        want, n_want = fastbody.loop_stage(ctx, clone_state(s), thresh,
                                           k_chain)
        evals = round(float(want.n_rows - s.n_rows) / s.alive.shape[0])
        assert n_want == evals
        for batch in (1, 3, 32):
            reads = fastbody.KERNEL.reads
            got, n = fastbody.KERNEL.gated(ctx, clone_state(s), thresh,
                                           k_chain, batch=batch)
            assert not state_mismatches(got, want), (thresh, batch)
            assert n == n_want, (thresh, batch)
            n = k_chain * -(-batch // k_chain)
            assert fastbody.KERNEL.reads - reads == 1 + -(-evals // n)


@pytest.mark.cuda
@pytest.mark.parametrize("albedo, res", [("affine", 32), ("full", 40)])
def test_body_kernel_multi_tile(cuda, albedo, res):
    """Multi-tile lane mode (2x2 tiles of (res/2)^2 in one cascade): every
    stage through run_stage equals the per-evaluation loop, and the
    kernels render the eager body's tiles bit for bit."""
    from cudavolumerenderer_tpu_torch.ops import fastbody

    scene = body_scene(cuda, albedo)
    settings = types.RenderSettings.from_flags(True)
    run, bad, modes = fastbody.run_stage, [], []
    fastbody.run_stage = checked_stages(bad, modes)
    try:
        got = body_render(cuda, scene, settings, res=res, multi=True,
                          two_level=True)
    finally:
        fastbody.run_stage = run
    assert not bad and modes[-1] == "drain", bad[:3]
    want = body_render(cuda, scene, settings, res=res, multi=True,
                       two_level=True, eager_body=True)
    assert got[0].shape == (4, res // 2, res // 2, 3)
    assert_same_render(got, want)


@pytest.mark.cuda
def test_body_kernel_split(cuda, monkeypatch):
    """A per-voxel albedo sent to 'split' by a small budget: the kernels
    read the scene's albedo grid at the tap, every stage through
    run_stage equals the per-evaluation loop, and the render equals the
    eager body's and the 'full' table's bit for bit."""
    from cudavolumerenderer_tpu_torch.ops import fastbody
    from cudavolumerenderer_tpu_torch.utils import occupancy

    shape = (16, 16, 32)
    scene = body_scene(cuda, "full", shape=shape)
    settings = types.RenderSettings.from_flags(True)
    full = body_render(cuda, scene, settings, two_level=True)
    monkeypatch.setattr(occupancy, "device_memory_budget",
                        lambda device=None: 40 * int(np.prod(shape)))
    assert fast._albedo_mode(scene, allow_split=True) == "split"
    run, bad, modes = fastbody.run_stage, [], []
    fastbody.run_stage = checked_stages(bad, modes)
    try:
        got = body_render(cuda, scene, settings, two_level=True)
    finally:
        fastbody.run_stage = run
    assert not bad and modes[-1] == "drain", bad[:3]
    want = body_render(cuda, scene, settings, two_level=True, eager_body=True)
    assert_same_render(got, want)
    assert_same_render(got, full)


@pytest.mark.cuda
def test_white_furnace_through_body_kernel(cuda):
    """Unit albedo and the null boundary: every pixel is exactly spp,
    one- and two-level, through the body kernel."""
    from cudavolumerenderer_tpu_torch.ops import fastbody

    d = procedural.blob_volume((24, 24, 24), n_blobs=3)
    scene = types.make_scene(types.make_medium(d, 1.0, scale=8.0,
                                               max_density=1.0, device=cuda))
    settings = types.RenderSettings.from_flags(
        True, russian_roulette=False, max_path_length=200, bsdf_kind="null")
    for two_level in (False, True):
        launches = fastbody.KERNEL.drain_launches
        img = body_render(cuda, scene, settings, res=16, two_level=two_level)[0]
        assert fastbody.KERNEL.drain_launches > launches  # one pool: drained
        np.testing.assert_array_equal(img.cpu().numpy(), 4.0)


@pytest.mark.cuda
def test_body_wrapper_runs_kernel_or_plain_by_device(cuda):
    """run_body launches the kernel on a kept state (counted), writes the
    `out` state it is given, equals the eager body there, and checks the
    state's types and layout."""
    from cudavolumerenderer_tpu_torch.ops import fastbody

    scene = body_scene(cuda)
    settings = types.RenderSettings.from_flags(True)
    kept, _ = kept_stages(cuda, scene, settings, two_level=True)
    ctx, s = kept[0][:2]
    out = clone_state(s)
    launches = fastbody.KERNEL.launches
    got, pending = fastbody.run_body(ctx, clone_state(s), out=out)
    assert fastbody.KERNEL.launches == launches + 1
    assert got.o.data_ptr() == out.o.data_ptr()
    assert not state_mismatches(got, ctx.plain(clone_state(s)))
    bad = s._replace(t=s.t.double())
    with pytest.raises(ValueError, match="t must be"):
        fastbody.run_body(ctx, bad)
    bad = s._replace(o=s.o.T.contiguous().T)
    with pytest.raises(ValueError, match="contiguous"):
        fastbody.run_body(ctx, bad)


def mode_render_checked(cuda, scene, settings, mode: str, **kw):
    """A render through the stage path with every stage and evaluation held
    against the eager body (checked_stages), then the eager render: the
    stages' modes, and the mode's launches (fastbody.KERNEL.by_mode)."""
    from cudavolumerenderer_tpu_torch.ops import fastbody

    run, bad, modes = fastbody.run_stage, [], []
    before = fastbody.KERNEL.by_mode[mode]
    fastbody.run_stage = checked_stages(bad, modes)
    try:
        got = body_render(cuda, scene, settings, **kw)
    finally:
        fastbody.run_stage = run
    assert fastbody.KERNEL.by_mode[mode] > before
    assert modes[-1] == "drain" and len(modes) > 1
    assert not bad, f"{len(bad)} evaluations or stages differ; first {bad[:3]}"
    want = body_render(cuda, scene, settings, eager_body=True, **kw)
    assert_same_render(got, want)
    assert float(got[1]) > 0 and torch.isfinite(got[0]).all()


@pytest.mark.cuda
@pytest.mark.parametrize("table", ["f32", "packed4", "split"])
@pytest.mark.parametrize("two_level", [False, True], ids=["1l", "2l"])
@pytest.mark.parametrize("spec_k", [2, 8, 32])
def test_body_kernel_speculative_steps_equal_eager_body(cuda, monkeypatch,
                                                        spec_k, two_level,
                                                        table):
    """tail_spec K in every pool (all are tail pools here): every stage
    through run_stage (gated, the last drained) equals the per-evaluation
    loop, each kernel evaluation the eager body's (speculate), and the
    render the eager render, bit for bit, at 24^2 (K 2, 32) and 40^2
    (K 8)."""
    from cudavolumerenderer_tpu_torch.utils import occupancy

    res = 40 if spec_k == 8 else 24
    kw = dict(two_level=two_level, tail_spec=spec_k, res=res)
    if table == "split":
        shape = (16, 16, 32)
        scene = body_scene(cuda, "full", shape=shape)
        monkeypatch.setattr(occupancy, "device_memory_budget",
                            lambda device=None: 40 * int(np.prod(shape)))
        assert fast._albedo_mode(scene, allow_split=True) == "split"
    else:
        scene = body_scene(cuda)
        if table == "packed4":
            kw["table_bits"] = 4
    settings = types.RenderSettings.from_flags(True)
    mode_render_checked(cuda, scene, settings, "spec", **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("multi", [False, True], ids=["tile", "multi"])
@pytest.mark.parametrize("bsdf", ["ggx", "null"])
@pytest.mark.parametrize("defer", [1, 4])
def test_body_kernel_deferred_flush_equals_eager_body(cuda, defer, bsdf,
                                                      multi):
    """defer_ggx G: every stage through run_stage (gated, the last
    drained; the flush from the evaluation's n_rows in the kernels)
    equals the per-evaluation loop, each evaluation the eager one, and the
    render the eager render (image, rays, rows, busy lanes, per-stage
    rows) bit for bit, in one tile at 24^2 and 40^2 and in 2x2 tiles."""
    scene = body_scene(cuda)
    settings = types.RenderSettings.from_flags(True, bsdf_kind=bsdf)
    res = 40 if defer == 4 else 24
    mode_render_checked(cuda, scene, settings, "defer", res=res, multi=multi,
                        two_level=True, defer_ggx=defer)


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [
    dict(defer_ggx=4), dict(tail_spec=8),
    dict(defer_ggx=1, tail_spec=4, tail_single_level=True),
], ids=["defer4", "spec8", "defer1-single4"])
def test_mode_drain_relaunches_and_single_launch(cuda, kw):
    """On the last stage's entry state in each mode: the drain relaunched
    at caps of 1 and 3 (the deferred flush's n_rows carried across the
    relaunches from the control words) equals the per-evaluation loop bit
    for bit, and one launch capped at 5 equals 5 eager evaluations."""
    from cudavolumerenderer_tpu_torch.ops import fastbody

    scene = body_scene(cuda)
    settings = types.RenderSettings.from_flags(True)
    kept, _ = kept_stages(cuda, scene, settings, two_level=True, **kw)
    ctx, s, thresh, k_chain = kept[-1]
    assert thresh == 0
    want, n_want = fastbody.loop_stage(ctx, clone_state(s), 0, k_chain)
    for cap in (1, 3):
        got, n = fastbody.KERNEL.drain(ctx, clone_state(s), k_chain, cap=cap)
        assert not state_mismatches(got, want) and n == n_want, cap
        assert fastbody.KERNEL.last_drain["launches"] > 1
    got, _ = fastbody.KERNEL.drain(ctx, clone_state(s), k_chain, cap=5,
                                   once=True)
    assert fastbody.KERNEL.last_drain["left"] > 0
    want = clone_state(s)
    for _ in range(5):
        want = ctx.plain(want)
    assert not state_mismatches(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [
    dict(two_level=True, tail_spec=8),
    dict(two_level=True, tail_single_level=True, tail_spec=16),
    dict(two_level=False, tail_spec=32),
    dict(two_level=True, defer_ggx=4),
    dict(two_level=True, defer_ggx=1, tail_spec=4),
], ids=["spec8-2l", "single16", "spec32-1l", "defer4", "defer1-spec4"])
def test_white_furnace_through_body_kernel_modes(cuda, kw):
    """Unit albedo and the null boundary: every pixel exactly spp through
    the speculative and the deferred modes of the body kernels (24^2 in
    pools of 576, 512 and 256 lanes: tail_spec acts only in a cascade of
    several pools)."""
    from cudavolumerenderer_tpu_torch.ops import fastbody

    d = procedural.blob_volume((24, 24, 24), n_blobs=3)
    scene = types.make_scene(types.make_medium(d, 1.0, scale=8.0,
                                               max_density=1.0, device=cuda))
    settings = types.RenderSettings.from_flags(
        True, russian_roulette=False, max_path_length=200, bsdf_kind="null")
    counts = dict(fastbody.KERNEL.by_mode)
    img = body_render(cuda, scene, settings, res=24, **kw)[0]
    on = {"spec": kw.get("tail_spec", 1) > 1,
          "defer": kw.get("defer_ggx", 0) > 0}
    for mode in fastbody.MODES:
        assert (fastbody.KERNEL.by_mode[mode] > counts[mode]) == on[mode]
    np.testing.assert_array_equal(img.cpu().numpy(), 4.0)


# -- fastSK's tail stage as one drain (csrc/tailpk.cu's drain_kernel) --------

def tail_stage_render(device, scene, settings, R, res=32, spp=4,
                      eager=False, steps=16, **kw):
    """A fastSK render with the tail kernel on a pool of R lanes (K =
    `steps`; body_render's keywords `kw`), keeping its tail stage's
    (context, a copy of the entry state, the stage's result); with `eager`
    the stage runs its eager loop (the eager_body=True path of the stage
    alone)."""
    import dataclasses

    kept, run = [], fast._run_tailpk_stage

    def keep(state, ctx):
        entry = clone_state(state)
        if eager:
            ctx = dataclasses.replace(ctx, eager_body=True)
        out = run(state, ctx)
        kept.append((ctx, entry, out))
        return out

    fast._run_tailpk_stage = keep
    try:
        out = body_render(device, scene, settings, res=res, spp=spp,
                          two_level=True, tail_pallas=True, tail_pk_width=R,
                          tail_pk_steps=steps, **kw)
    finally:
        fast._run_tailpk_stage = run
    assert len(kept) == 1
    return kept[0], out


#: (id, pool width R, scene keywords, settings keywords[, tail_stage_render
#: keywords])
TAIL_DRAIN_CASES = [
    ("r128", 128, {}, {}),
    # micro_medical2's tail rows: widths 256 and 512, 32 steps
    ("r256-res24", 256, {}, {}, dict(res=24)),
    # (the tail pool takes at most the last stage's width: 1,024 here)
    ("r512-res40", 512, {}, {}, dict(res=40, min_width=1024)),
    ("r128-k32-res24", 128, {}, {}, dict(res=24, steps=32)),
    ("r256-k32-res40", 256, {}, {}, dict(res=40, steps=32)),
    # 40 is no power of two: power-of-two sizes can hide an indexing fault
    ("r40", 40, {}, {}),
    ("rr-off", 128, {}, dict(russian_roulette=False)),
    ("null", 128, {}, dict(bsdf_kind="null")),
    ("null-r40-rr-off", 40, {}, dict(bsdf_kind="null",
                                     russian_roulette=False)),
    ("const-albedo", 128, dict(albedo="const"), {}),
    ("heitz-r40", 40, {}, dict(mitsuba_comparable=False)),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", TAIL_DRAIN_CASES,
                         ids=[c[0] for c in TAIL_DRAIN_CASES])
def test_tail_drain_equals_eager_loop(cuda, case):
    """The tail stage through the drain (one launch, one host read, no
    tail-kernel launch) equals its eager loop on the same entry state in
    every FastState field, n_rays, n_rows and n_busy, bit for bit; the
    render through it equals the render whose stage runs the eager loop
    (image, rays, rows, busy lanes, per-stage rows)."""
    from cudavolumerenderer_tpu_torch.ops import taildrain

    _, R, scene_kw, settings_kw, *render_kw = case
    render_kw = render_kw[0] if render_kw else {}
    scene = body_scene(cuda, **scene_kw)
    settings_kw = dict(settings_kw)
    settings = types.RenderSettings.from_flags(
        settings_kw.pop("mitsuba_comparable", True), **settings_kw)
    taildrain.KERNEL.reset()
    launches = tailpk.KERNEL.launches
    (ctx, entry, got), out = tail_stage_render(cuda, scene, settings, R,
                                               **render_kw)
    assert entry.alive.shape[0] == R
    assert taildrain.KERNEL.drain_launches == taildrain.KERNEL.reads == 1
    assert tailpk.KERNEL.launches == launches
    rounds = taildrain.KERNEL.last_drain["E"]
    want = fast.plain_stage(ctx, clone_state(entry))
    assert taildrain.KERNEL.plain_rounds == rounds > 0
    assert tailpk.KERNEL.launches == launches + rounds
    assert not state_mismatches(got, want)
    assert float(got.n_rows - entry.n_rows) == R * rounds
    (_, entry_e, _), want_out = tail_stage_render(cuda, scene, settings, R,
                                                  eager=True, **render_kw)
    assert not state_mismatches(entry_e, entry)
    assert_same_render(out, want_out)
    assert torch.isfinite(out[0]).all() and float(out[1]) > 0


@pytest.mark.cuda
def test_tail_drain_relaunches_at_the_cap(cuda):
    """With DRAIN_CAP lowered to 7 (and 1) the drain stores the lanes at
    the cap with their exit_box flags and launches again: the same state
    as the eager loop bit for bit, ceil(E / cap) launches and as many host
    reads, E the loop's rounds and the longest lane's."""
    from cudavolumerenderer_tpu_torch.ops import taildrain

    scene = body_scene(cuda)
    settings = types.RenderSettings.from_flags(True)
    (ctx, entry, _), _ = tail_stage_render(cuda, scene, settings, 40)
    rounds = taildrain.KERNEL.plain_rounds
    want = fast.plain_stage(ctx, clone_state(entry))
    rounds = taildrain.KERNEL.plain_rounds - rounds
    assert rounds > 7
    for cap in (7, 1):
        reads = taildrain.KERNEL.reads
        got = taildrain.KERNEL.drain(ctx, clone_state(entry), cap=cap)
        assert not state_mismatches(got, want), cap
        info = taildrain.KERNEL.last_drain
        assert info["E"] == info["L"] == rounds
        assert info["launches"] == -(-rounds // cap)
        assert taildrain.KERNEL.reads - reads == info["launches"]


@pytest.mark.cuda
def test_tail_drain_checks_its_inputs(cuda):
    """The drain raises on a field of the wrong type or layout, and its
    wrapper on a device without a kernel; a stage with no lane pending
    launches once and returns the state unchanged."""
    from cudavolumerenderer_tpu_torch.ops import taildrain

    scene = body_scene(cuda)
    settings = types.RenderSettings.from_flags(True)
    (ctx, entry, got), _ = tail_stage_render(cuda, scene, settings, 40)
    with pytest.raises(ValueError, match="t must be"):
        taildrain.KERNEL.drain(ctx, entry._replace(t=entry.t.double()))
    with pytest.raises(ValueError, match="contiguous"):
        taildrain.KERNEL.drain(ctx, entry._replace(o=entry.o.T.contiguous().T))
    done = clone_state(got)
    again = taildrain.KERNEL.drain(ctx, clone_state(done))
    assert not state_mismatches(again, done)
    assert taildrain.KERNEL.last_drain["E"] == 0


# -- render_diff's replay body kernel (csrc/replaybody.cu) ------------------

#: the evaluations whose states are kept (0: every lane starts a segment,
#: no tracking step yet; 4: tracking in the widest pool; 20 and 100 deeper,
#: in narrower pools), and the first evaluation of these pool widths
REPLAY_KEEP = (0, 4, 20, 100)
REPLAY_WIDTHS = (16384, 4096)
#: atomic pass B against the eager body: per voxel, and the sums
GRAD_RTOL, GRAD_ATOL, GRAD_SUM = 1e-4, 1e-5, 1e-6


def replay_problem(device, bsdf="ggx", const_albedo=False, res=128, spp=4,
                   n=32, rr=True, fov=0.8):
    """A blob volume (scale 12, as inverse_256's), a per-voxel or constant
    albedo, the camera's lanes and a random image cotangent:
    (scene, settings, tables, image_id, o0, d0, rng, g_img)."""
    d = procedural.medical_volume((n,) * 3, n_blobs=6).astype(np.float32)
    rs = np.random.RandomState(3)
    alb = (np.full((1, 1, 1, 4), 0.7, np.float32) if const_albedo
           else (0.3 + 0.6 * rs.rand(n, n, n, 4)).astype(np.float32))
    scene = differentiable.SceneSpec(scale=12.0).build(d, alb, device)
    cam = differentiable.CameraSpec(res_x=res, res_y=res,
                                    fov_x_deg=fov).build(device)
    settings = types.RenderSettings.from_flags(
        True, russian_roulette=rr, max_path_length=64, bsdf_kind=bsdf)
    _, image_id, o0, d0, rng = differentiable._lane_setup(
        cam, (res, res), spp, 5)
    g_img = torch.tensor(rs.rand(res, res, 3).astype(np.float32),
                         device=device)
    tables = differentiable._build_brick_tab(scene.medium.density.data)
    return scene, settings, tables, image_id, o0, d0, rng, g_img


def cotangents(scene, device):
    n_chan = scene.medium.albedo.data.shape[-1]
    rows = scene.medium.albedo.data.numel() // n_chan
    return (torch.zeros(scene.medium.density.data.numel(), device=device),
            torch.zeros((rows, n_chan), device=device))


def pass_b_weights(problem, device):
    """The primal's per-lane radiance through the eager replay, and pass B's
    (s_lane, g_lane) from it."""
    scene, settings, tables, image_id, o0, d0, rng, g_img = problem
    n = o0.shape[0]
    prim = differentiable._replay(
        scene, settings, o0, d0, rng, torch.zeros(n, device=device),
        torch.zeros((n, 3), device=device), False, None, None, tables,
        eager_body=True)
    g_lane = g_img.reshape(-1, 3)[image_id] * prim.radiance
    return torch.sum(g_lane, dim=-1), g_lane


def kept_replay(problem, device, keep_evals=REPLAY_KEEP,
                keep_widths=REPLAY_WIDTHS):
    """Pass B of `problem` through the eager body on the card, keeping
    copies of the pool at the evaluations `keep_evals`, at the first
    evaluation of each `keep_widths` pool, and at each stage's entry:
    ({tag: pool}, [(pool, thresh, k_chain, last)])."""
    from cudavolumerenderer_tpu_torch.ops import replaybody

    scene, settings, tables, image_id, o0, d0, rng, g_img = problem
    s_lane, g_lane = pass_b_weights(problem, device)
    dd, da = cotangents(scene, device)
    kept, stages, count, seen = {}, [], [0], set()
    plain, loop = replaybody.plain_body, replaybody.loop_stage

    def keep_body(ctx, s):
        width = s.alive.shape[0]
        if count[0] in keep_evals:
            kept[f"evaluation {count[0]}"] = clone_state(s)
        elif width in keep_widths and width not in seen:
            seen.add(width)
            kept[f"first {width}-lane evaluation"] = clone_state(s)
        count[0] += 1
        return plain(ctx, s)

    def keep_stage(ctx, s, thresh, k_chain, body=replaybody.run_body):
        stages.append((clone_state(s), thresh, k_chain))
        return loop(ctx, s, thresh, k_chain, body)

    replaybody.plain_body, replaybody.loop_stage = keep_body, keep_stage
    try:
        differentiable._replay(scene, settings, o0, d0, rng, s_lane, g_lane,
                               True, dd, da, tables, eager_body=True)
    finally:
        replaybody.plain_body, replaybody.loop_stage = plain, loop
    last = len(stages) - 1
    return kept, [(s, t, k, i == last) for i, (s, t, k) in enumerate(stages)]


def assert_grads_close(got, want):
    """Atomic adds reorder each voxel's float32 sum: per voxel within
    GRAD_RTOL of it and GRAD_ATOL of the largest, the sums within GRAD_SUM
    of the absolute sum."""
    got, want = got.double().cpu(), want.double().cpu()
    scale = float(want.abs().max())
    assert bool(((got - want).abs() <= GRAD_RTOL * want.abs()
                 + GRAD_ATOL * scale).all())
    assert abs(float(got.sum() - want.sum())) <= GRAD_SUM * float(
        want.abs().sum())


REPLAY_CASES = [("ggx", False), ("ggx", True), ("null", False),
                ("null", True)]


@pytest.mark.cuda
@pytest.mark.parametrize("bsdf, const_albedo", REPLAY_CASES,
                         ids=[f"{b}-{'const' if c else 'grid'}"
                              for b, c in REPLAY_CASES])
def test_replay_kernel_evaluation_equals_eager_body(cuda, bsdf, const_albedo):
    """On pools kept at evaluations 0, 4, 20 and 100 of a 65,536-lane pass B
    (128^2 x 4, the volume filling the view, Russian roulette off so the
    16,384-lane pool has evaluations) and at the first 16,384- and
    4,096-lane evaluations: one
    kernel evaluation equals one eager evaluation in every _Lanes field and
    the alive count, for the primal and for pass B; pass B's cotangents are
    bit-equal under deterministic algorithms (buffer mode) and within
    GRAD_* with atomics."""
    from cudavolumerenderer_tpu_torch.ops import replaybody

    problem = replay_problem(cuda, bsdf, const_albedo, rr=False, fov=0.6)
    scene, settings, tables = problem[:3]
    context = functools.partial(differentiable.replay_context, scene,
                                settings, tables)
    kept, _ = kept_replay(problem, cuda)
    assert len(kept) == len(REPLAY_KEEP) + len(REPLAY_WIDTHS), list(kept)
    assert kept["evaluation 0"].alive.shape[0] == 65536
    tracking = kept["evaluation 4"]
    assert tracking.alive.shape[0] == 65536
    assert bool((tracking.seg & tracking.alive & tracking.in_med).any())
    was = torch.are_deterministic_algorithms_enabled()
    for tag, s in kept.items():
        ctx = context(False)
        got, count = replaybody.run_body(ctx, clone_state(s))
        want = ctx.plain(clone_state(s))
        assert not state_mismatches(got, want), (tag, "primal")
        assert int(count) == int(want.alive.sum())
        for deterministic in (False, True):
            torch.use_deterministic_algorithms(deterministic, warn_only=True)
            try:
                dk, ak = cotangents(scene, cuda)
                de, ae = cotangents(scene, cuda)
                ctx_k = context(True, dk, ak)
                ctx_e = context(True, de, ae)
                assert ctx_k.record == (replaybody.REC_BUFFERS if deterministic
                                        else replaybody.REC_ATOMIC)
                got, _ = replaybody.run_body(ctx_k, clone_state(s))
                want = ctx_e.plain(clone_state(s))
            finally:
                torch.use_deterministic_algorithms(was)
            assert not state_mismatches(got, want), (tag, "pass B")
            if deterministic:
                assert torch.equal(dk, de) and torch.equal(ak, ae), tag
            else:
                assert_grads_close(dk, de)
                assert_grads_close(ak, ae)


@pytest.mark.cuda
@pytest.mark.parametrize("record", [False, True], ids=["primal", "pass-b"])
def test_replay_stages_equal_the_loop(cuda, record):
    """Every stage of a 65,536-lane replay (GGX, per-voxel albedo):
    gated chains at batches 1, 3 and 32 and the drain at caps 1, 5 and
    8,192 equal loop_stage (the kernel per evaluation) in every _Lanes
    field and in the evaluations they report (so `iterations` and `rows`);
    the host reads the control words once per batch and once at the start,
    the drain once per launch, and E = k_chain * ceil(L / k_chain).  Pass
    B's cotangents agree within GRAD_*."""
    from cudavolumerenderer_tpu_torch.ops import replaybody

    problem = replay_problem(cuda)
    scene, settings, tables = problem[:3]
    context = functools.partial(differentiable.replay_context, scene,
                                settings, tables)
    _, stages = kept_replay(problem, cuda, keep_evals=(), keep_widths=())
    assert [t for _, t, _, _ in stages][-1] == 0 and len(stages) == 5
    k = replaybody.KERNEL
    for s, thresh, k_chain, last in stages:
        dw, aw = cotangents(scene, cuda)
        want, n_want = replaybody.loop_stage(
            context(record, dw, aw),
            clone_state(s), thresh, k_chain)
        runs = ((1, 3, 32) if thresh else (1, 5, replaybody.DRAIN_CAP))
        for arg in runs:
            dg, ag = cotangents(scene, cuda)
            ctx = context(record, dg, ag)
            reads = k.reads
            if thresh:
                got, n = k.gated(ctx, clone_state(s), thresh, k_chain,
                                 batch=arg)
                per = k_chain * -(-arg // k_chain)
                assert k.reads - reads == 1 + -(-n_want // per)
            else:
                got, n = k.drain(ctx, clone_state(s), k_chain, cap=arg)
                info = k.last_drain
                assert n == info["E"] == k_chain * -(-info["L"] // k_chain)
                assert info["launches"] == max(1, -(-info["L"] // arg))
                assert k.reads - reads == info["launches"]
            assert n == n_want, (thresh, arg)
            assert not state_mismatches(got, want), (thresh, arg)
            if record:
                assert_grads_close(dg, dw)
                assert_grads_close(ag, aw)


def replay_diff_render(device, eager_body, bsdf="ggx", const_albedo=False,
                res=64, spp=4):
    d = procedural.medical_volume((32,) * 3, n_blobs=6).astype(np.float32)
    rs = np.random.RandomState(3)
    alb = (np.full((1, 1, 1, 4), 0.7, np.float32) if const_albedo
           else (0.3 + 0.6 * rs.rand(32, 32, 32, 4)).astype(np.float32))
    dt = torch.tensor(d, device=device, requires_grad=True)
    at = torch.tensor(alb, device=device, requires_grad=True)
    settings = types.RenderSettings.from_flags(
        True, russian_roulette=True, max_path_length=64, bsdf_kind=bsdf)
    stats = {}
    img = differentiable.render_diff(
        dt, at, 9, differentiable.SceneSpec(scale=12.0),
        differentiable.CameraSpec(res_x=res, res_y=res, fov_x_deg=0.8),
        settings, (res, res), spp, True, stats=stats, eager_body=eager_body)
    img.backward(torch.tensor(rs.rand(res, res, 3).astype(np.float32),
                              device=device))
    return img.detach(), dt.grad, at.grad, stats


@pytest.mark.cuda
@pytest.mark.parametrize("const_albedo", [False, True], ids=["grid", "const"])
def test_render_diff_through_replay_kernel(cuda, const_albedo):
    """render_diff (64^2 x 4, pools 16,384 / 8,192 / 4,096, GGX, RR on)
    through the kernel against eager_body=True: the replay iterations
    equal, the image and the cotangents within GRAD_* with atomics (the
    image's splat adds a pixel's samples with atomics too) and bit for bit
    under deterministic algorithms; the kernel path launches the kernels
    and never the eager body."""
    from cudavolumerenderer_tpu_torch.ops import replaybody

    k = replaybody.KERNEL
    want = replay_diff_render(cuda, True, const_albedo=const_albedo)
    before = (k.launches, k.drain_launches, k.plain_evals)
    got = replay_diff_render(cuda, False, const_albedo=const_albedo)
    assert k.launches > before[0] and k.drain_launches > before[1]
    assert k.plain_evals == before[2]
    assert got[3] == want[3] and got[3]["primal_iters"] == got[3][
        "pass_b_iters"]
    for g, w in zip(got[:3], want[:3]):
        assert_grads_close(g, w)
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        got = replay_diff_render(cuda, False, const_albedo=const_albedo)
        want = replay_diff_render(cuda, True, const_albedo=const_albedo)
    finally:
        torch.use_deterministic_algorithms(was)
    for g, w in zip(got[:3], want[:3]):
        assert torch.equal(g, w)


@pytest.mark.cuda
def test_replay_wrapper_runs_kernel_or_raises(cuda, monkeypatch):
    """run_body launches the kernel (counted) and writes the `out` pool it
    is given; a wrong dtype raises; a failed build raises out of
    render_diff, with no fallback to the eager body."""
    from cudavolumerenderer_tpu_torch.ops import replaybody
    from cudavolumerenderer_tpu_torch.utils import cuda_build

    problem = replay_problem(cuda, res=32, spp=1)
    scene, settings, tables = problem[:3]
    kept, _ = kept_replay(problem, cuda, keep_evals=(3,), keep_widths=())
    s = kept["evaluation 3"]
    ctx = differentiable.replay_context(scene, settings, tables, False)
    out = clone_state(s)
    launches = replaybody.KERNEL.launches
    got, _ = replaybody.run_body(ctx, clone_state(s), out=out)
    assert replaybody.KERNEL.launches == launches + 1
    assert got.o.data_ptr() == out.o.data_ptr()
    assert not state_mismatches(got, ctx.plain(clone_state(s)))
    with pytest.raises(ValueError, match="t must be"):
        replaybody.run_body(ctx, s._replace(t=s.t.double()))

    def broken(source):
        raise RuntimeError("nvcc failed on replaybody.cu")

    monkeypatch.setattr(replaybody, "KERNEL", replaybody.ReplayBodyKernel())
    monkeypatch.setattr(cuda_build, "build_library", broken)
    plain = replaybody.KERNEL.plain_evals
    with pytest.raises(RuntimeError, match="nvcc failed"):
        replay_diff_render(cuda, False, res=16, spp=1)
    assert replaybody.KERNEL.plain_evals == plain


# -- the integrator family's body kernels (csrc/familybody.cu) ------------------------

# pool widths: two powers of two and two tiles that are not (24^2, 40^2 lanes:
# powers of two cannot tell the float rules apart)
FAMILY_WIDTHS = [65536, 4096, 24 * 24, 40 * 40]
FAMILY_TILES = {65536: (128, 128, 4), 4096: (64, 64, 1), 576: (24, 24, 1),
                1600: (40, 40, 1)}
FAMILY_SETTINGS = {
    "default": dict(),
    "nearest": dict(mitsuba_comparable=False),
    "null-no-rr": dict(bsdf_kind="null", russian_roulette=False,
                       max_path_length=6),
}
FAMILY_MODES = ["bounce", "bounce-splat", "refill-1", "refill-8",
                "refill-1024", "refill-stream", "extend", "extend-defer",
                "flush"]


def family_settings(name):
    kw = dict(FAMILY_SETTINGS[name])
    return types.RenderSettings.from_flags(kw.pop("mitsuba_comparable", True),
                                           **kw)


def family_ctx(device, width, settings, group=1):
    """The blob scene of scheduler_render and a context whose queue holds 3
    paths per lane of a `width`-lane pool."""
    from cudavolumerenderer_tpu_torch.ops import familybody

    tw, th, _ = FAMILY_TILES[width]
    d = procedural.blob_volume()
    albedo = np.stack([d, 0.5 * np.ones_like(d), 1.0 - d], -1)
    scene = types.make_scene(types.make_medium(d, albedo, scale=40.0,
                                               max_density=1.0, device=device))
    camera = make_camera(tw, th, device=device)
    n_paths = 3 * width
    return familybody.make_context(
        scene, settings, camera, (tw, th), torch.tensor([2.0, 1.0],
                                                        device=device),
        (tw + 4, th + 2), n_paths, 9, 5, group=group)


def family_pool(ctx, width, stream, defer=False, iters=4):
    """A pool of `width` lanes after `iters` plain iterations (a refill and
    a bounce or an extend), some lanes alive, some dead, some pending."""
    from cudavolumerenderer_tpu_torch.models import (
        integrator, regeneration, streaming,
    )
    from cudavolumerenderer_tpu_torch.ops import familybody

    dev = ctx.scene.device
    accum = torch.zeros((ctx.tile_dim[0] * ctx.tile_dim[1], 3), device=dev)
    issued = torch.zeros((), dtype=torch.int64, device=dev)
    if stream:
        s = streaming.initial_stream_state(width, ctx.seed, dev)
        for _ in range(iters):
            s, _, issued = familybody.plain_body(ctx, "refill", s,
                                                 issued=issued)
            s, _ = familybody.plain_body(ctx, "extend", s, accum=accum,
                                         defer=defer)
        return familybody.own(s), None, issued, accum
    p = integrator.PathState(**regeneration.empty_pool(width, ctx.seed, dev))
    img = torch.zeros(width, dtype=torch.int64, device=dev)
    for _ in range(iters):
        p, img, issued = familybody.plain_body(ctx, "refill", p, image_id=img,
                                               issued=issued)
        p, _ = familybody.plain_body(ctx, "bounce", p, image_id=img,
                                     accum=accum)
    return familybody.own(p), img, issued, accum


def family_mismatches(a, b, names):
    """The fields of two pools that differ bit for bit (NaN equal to NaN)."""
    from cudavolumerenderer_tpu_torch.ops.stages import lane_field

    bad = []
    for n in names:
        x, y = lane_field(a, n), lane_field(b, n)
        if x.dtype == torch.float32:
            x, y = x.view(torch.int32), y.view(torch.int32)
        if not torch.equal(x, y):
            bad.append(n)
    if a.n_rays.view(torch.int32).item() != b.n_rays.view(torch.int32).item():
        bad.append("n_rays")
    return bad


@pytest.mark.cuda
@pytest.mark.parametrize("width", FAMILY_WIDTHS)
@pytest.mark.parametrize("mode", FAMILY_MODES)
def test_family_entry_equals_eager(cuda, mode, width):
    """One launch of each entry point and mode equals its eager function
    in every lane field bit for bit (o, d, throughput, radiance, alive, the
    RNG words, image_id, paths_issued, and a stream pool's tracking, t,
    max_t, normal, pending and p_scat), n_rays and the alive count; the
    splat's image to float-summation order (both add with atomics)."""
    from cudavolumerenderer_tpu_torch.ops import familybody

    op = mode.split("-")[0]
    group = int(mode.split("-")[1]) if mode in (
        "refill-1", "refill-8", "refill-1024") else 1
    stream = mode in ("refill-stream", "extend", "extend-defer", "flush")
    defer = mode in ("extend-defer", "flush")
    ctx = family_ctx(cuda, width, family_settings("default"), group)
    s, img, issued, accum = family_pool(ctx, width, stream, defer)
    names = familybody.LANE_FIELDS if stream else familybody.PATH_FIELDS
    splat = mode == "bounce-splat" or op in ("extend", "flush")
    a_acc, b_acc = accum.clone(), accum.clone()

    def args(acc):
        kw = dict(defer=defer) if op == "extend" else {}
        if img is not None and (op == "refill" or splat):
            kw["image_id"] = img.clone()
        if op == "refill":
            kw["issued"] = issued.clone()
        if splat:
            kw["accum"] = acc
        return kw

    before = familybody.KERNEL.by_op[op]
    got = familybody.run_body(ctx, op, familybody.own(s), **args(a_acc))
    want = familybody.plain_body(ctx, op, familybody.own(s), **args(b_acc))
    torch.cuda.synchronize()
    assert familybody.KERNEL.by_op[op] == before + 1
    assert not family_mismatches(got[0], want[0], names)
    if op == "refill":
        assert torch.equal(got[1], want[1]) and int(got[2]) == int(want[2])
    elif op != "flush":
        assert int(got[1]) == int(torch.count_nonzero(want[0].alive))
    torch.testing.assert_close(a_acc, b_acc, rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("settings", ["nearest", "null-no-rr"])
@pytest.mark.parametrize("mode", ["bounce-splat", "extend", "flush"])
def test_family_entry_equals_eager_in_other_settings(cuda, mode, settings):
    """The nearest sampler, the null BSDF and no Russian roulette, at 40^2
    lanes."""
    from cudavolumerenderer_tpu_torch.ops import familybody

    op = mode.split("-")[0]
    stream = op != "bounce"
    ctx = family_ctx(cuda, 1600, family_settings(settings))
    s, img, _, accum = family_pool(ctx, 1600, stream, defer=op == "flush")
    names = familybody.LANE_FIELDS if stream else familybody.PATH_FIELDS
    kw = {} if stream else dict(image_id=img)
    a_acc, b_acc = accum.clone(), accum.clone()
    got = familybody.run_body(ctx, op, familybody.own(s), accum=a_acc, **kw)
    want = familybody.plain_body(ctx, op, familybody.own(s), accum=b_acc,
                                 **kw)
    assert not family_mismatches(got[0], want[0], names)
    torch.testing.assert_close(a_acc, b_acc, rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("settings", list(FAMILY_SETTINGS))
@pytest.mark.parametrize("width", FAMILY_WIDTHS)
def test_family_drain_equals_trace(cuda, width, settings):
    """naiveSK's drain (one launch: every lane bounces in registers until it
    dies or reaches max_path_length) equals trace's loop of eager bounces
    in every lane field and n_rays bit for bit, in as many bounces."""
    from cudavolumerenderer_tpu_torch.models import naive
    from cudavolumerenderer_tpu_torch.ops import familybody

    ctx = family_ctx(cuda, width, family_settings(settings))
    tw, th, spp = FAMILY_TILES[width]
    _, s = naive.start_batch(ctx.camera, (tw, th), ctx.tile_offset,
                             ctx.full_resolution, spp, 9, 5)
    familybody.KERNEL.reset()
    got = familybody.trace(ctx, s, True)
    n_kernel = familybody.KERNEL.evals
    want = familybody.trace(ctx, s, False)
    assert familybody.KERNEL.drain_launches == 1
    assert not family_mismatches(got, want, familybody.PATH_FIELDS)
    assert familybody.KERNEL.evals == 2 * n_kernel > 0


# the family's rows: (label, render_tile, keywords)
def family_rows():
    from cudavolumerenderer_tpu_torch.models import (
        naive, regeneration, streaming, wavefront_mk,
    )
    return [
        ("naiveSK", naive.render_tile, {}),
        ("naiveMK", wavefront_mk.render_tile, {}),
        ("naiveMK no compaction", wavefront_mk.render_tile,
         {"compaction": False}),
        ("regenerationSK 0", regeneration.render_tile, {"n_lanes": 1000}),
        ("regenerationSK 1", regeneration.render_tile,
         {"n_lanes": 1003, "refill_group": 8}),
        ("regenerationSK 2", regeneration.render_tile,
         {"n_lanes": 2100, "refill_group": 1024}),
        ("streamingSK", streaming.render_tile, {"n_lanes": 1000}),
        ("sortingSK", streaming.render_tile,
         {"n_lanes": 1000, "sort_every": 8, "defer_access": True}),
        ("streamingMK", wavefront_mk.render_tile_streaming_mk,
         {"n_lanes": 1024}),
    ]


FAMILY_LABELS = ["naiveSK", "naiveMK", "naiveMK no compaction",
                 "regenerationSK 0", "regenerationSK 1", "regenerationSK 2",
                 "streamingSK", "sortingSK", "streamingMK"]


def family_render(cuda, label, res, eager_body, settings=None, albedo=None):
    """A res^2 x 2 render of the blob scene through the row's render_tile:
    (image, n_rays, the loop's evaluations, the kernels' launches)."""
    from cudavolumerenderer_tpu_torch.ops import familybody

    _, fn, kw = next(r for r in family_rows() if r[0] == label)
    d = procedural.blob_volume()
    if albedo is None:
        albedo = np.stack([d, 0.5 * np.ones_like(d), 1.0 - d], -1)
    scene = types.make_scene(types.make_medium(d, albedo, scale=40.0,
                                               max_density=1.0, device=cuda))
    settings = settings or types.RenderSettings.from_flags(True)
    familybody.KERNEL.reset()
    img, n_rays = fn(scene, make_camera(res, res, device=cuda), settings,
                     (res, res), torch.zeros(2, device=cuda), (res, res), 2,
                     9, 0, eager_body=eager_body, **kw)
    k = familybody.KERNEL
    return (img, float(n_rays), k.evals,
            sum(k.by_op.values()) + k.drain_launches, sum(
                k.plain_evals.values()))


@pytest.mark.cuda
@pytest.mark.parametrize("res", [24, 40])
@pytest.mark.parametrize("label", FAMILY_LABELS)
def test_family_row_kernels_equal_eager(cuda, label, res):
    """Each row through the kernels (the drain, one launch per bounce,
    gated chains of refill and bounce or extend) gives the eager row's
    n_rays and evaluations exactly and its image to float-summation order
    (the splat's atomics), with no eager evaluation."""
    img, n_rays, evals, launches, plain = family_render(cuda, label, res,
                                                        False)
    want, want_rays, want_evals, no_launch, _ = family_render(cuda, label,
                                                             res, True)
    assert launches > 0 and plain == 0 and no_launch == 0
    assert n_rays == want_rays and evals == want_evals
    torch.testing.assert_close(img, want, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("label", FAMILY_LABELS)
def test_family_white_furnace_through_kernels(cuda, label):
    """Null BSDF, albedo 1: every pixel exactly 1.0 through every kernel
    path."""
    settings = types.RenderSettings.from_flags(True, bsdf_kind="null")
    img, _, _, launches, plain = family_render(cuda, label, 24, False,
                                               settings=settings, albedo=1.0)
    assert launches > 0 and plain == 0
    assert torch.equal(img / 2, torch.ones_like(img))


@pytest.mark.cuda
def test_family_wrapper_runs_kernel_or_raises(cuda, monkeypatch):
    """run_body launches the entry point (counted) and writes the `out`
    pool it is given; a wrong dtype raises; a failed build raises out of
    every row's render, with no fallback to the eager functions."""
    from cudavolumerenderer_tpu_torch.ops import familybody
    from cudavolumerenderer_tpu_torch.utils import cuda_build

    ctx = family_ctx(cuda, 576, family_settings("default"))
    s, img, _, accum = family_pool(ctx, 576, False)
    out = familybody.own(s)
    before = familybody.KERNEL.by_op["bounce"]
    got, _ = familybody.run_body(ctx, "bounce", familybody.own(s), out=out)
    assert familybody.KERNEL.by_op["bounce"] == before + 1
    assert got.o.data_ptr() == out.o.data_ptr()
    want, _ = familybody.plain_body(ctx, "bounce", familybody.own(s))
    assert not family_mismatches(got, want, familybody.PATH_FIELDS)
    with pytest.raises(ValueError, match="throughput must be"):
        familybody.run_body(ctx, "bounce",
                            s._replace(throughput=s.throughput.double()))

    def broken(source):
        raise RuntimeError("nvcc failed on familybody.cu")

    monkeypatch.setattr(familybody, "KERNEL", familybody.FamilyBodyKernel())
    monkeypatch.setattr(cuda_build, "build_library", broken)
    for label in FAMILY_LABELS:
        with pytest.raises(RuntimeError, match="nvcc failed"):
            family_render(cuda, label, 24, False)
        assert sum(familybody.KERNEL.plain_evals.values()) == 0, label


# -- the variable boundary's march in the family kernels (csrc/familybody.cu) --------

def variable_settings(**kw):
    """--boundary variable at a threshold the blob's edge stays under (so
    marches take steps), GGX and RR unless given."""
    return types.RenderSettings.from_flags(
        True, boundary="variable", boundary_threshold=0.05, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("width", [24 * 24, 40 * 40])
@pytest.mark.parametrize("mode", ["bounce", "bounce-splat", "drain"])
def test_family_variable_bounce_equals_eager(cuda, mode, width):
    """Under the variable boundary the bounce (the isosurface march in
    registers, then the bounce) equals bounce_step in every lane field and
    n_rays bit for bit, per launch and through naiveSK's drain."""
    from cudavolumerenderer_tpu_torch.models import naive
    from cudavolumerenderer_tpu_torch.ops import familybody

    settings = variable_settings()
    ctx = family_ctx(cuda, width, settings)
    if mode == "drain":
        tw, th, spp = FAMILY_TILES[width]
        _, s = naive.start_batch(ctx.camera, (tw, th), ctx.tile_offset,
                                 ctx.full_resolution, spp, 9, 5)
        got = familybody.trace(ctx, s, True)
        want = familybody.trace(ctx, s, False)
        assert not family_mismatches(got, want, familybody.PATH_FIELDS)
        return
    s, img, _, accum = family_pool(ctx, width, False)
    kw = dict(image_id=img) if mode == "bounce-splat" else {}
    a_acc, b_acc = accum.clone(), accum.clone()
    if kw:
        kw_a, kw_b = dict(kw, accum=a_acc), dict(kw, accum=b_acc)
    else:
        kw_a = kw_b = {}
    got = familybody.run_body(ctx, "bounce", familybody.own(s), **kw_a)
    want = familybody.plain_body(ctx, "bounce", familybody.own(s), **kw_b)
    assert not family_mismatches(got[0], want[0], familybody.PATH_FIELDS)
    torch.testing.assert_close(a_acc, b_acc, rtol=1e-5, atol=1e-6)


VARIABLE_LABELS = ["naiveSK", "naiveMK", "regenerationSK 0", "streamingSK"]


@pytest.mark.cuda
@pytest.mark.parametrize("res", [24, 40])
@pytest.mark.parametrize("label", VARIABLE_LABELS)
def test_family_variable_rows_kernels_equal_eager(cuda, label, res):
    """Each row under --boundary variable through the kernels gives the
    eager row's n_rays and evaluations exactly and its image to
    float-summation order, with no eager evaluation."""
    settings = variable_settings()
    img, n_rays, evals, launches, plain = family_render(
        cuda, label, res, False, settings=settings)
    want, want_rays, want_evals, no_launch, _ = family_render(
        cuda, label, res, True, settings=settings)
    assert launches > 0 and plain == 0 and no_launch == 0
    assert n_rays == want_rays and evals == want_evals
    torch.testing.assert_close(img, want, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("label", ["naiveSK", "regenerationSK 0"])
def test_family_variable_white_furnace_through_kernels(cuda, label):
    """Null BSDF, albedo 1, the variable boundary: every pixel exactly 1.0
    through the kernels (the march moves events, it makes no energy)."""
    settings = variable_settings(bsdf_kind="null")
    img, _, _, launches, plain = family_render(cuda, label, 24, False,
                                               settings=settings, albedo=1.0)
    assert launches > 0 and plain == 0
    assert torch.equal(img / 2, torch.ones_like(img))


# -- fastQ's body kernels (csrc/fastqbody.cu) -----------------------------------------

FASTQ_TILES = {576: (24, 24), 1600: (40, 40)}


def fastq_setup(cuda, width, two_level, settings=None, albedo=None):
    """The blob scene, a context of a 3-paths-per-lane queue on a
    `width`-lane pool, its initial state and image."""
    from cudavolumerenderer_tpu_torch.models import fastq

    tw, th = FASTQ_TILES[width]
    d = procedural.blob_volume()
    if albedo is None:
        albedo = np.stack([d, 0.5 * np.ones_like(d), 1.0 - d], -1)
    scene = types.make_scene(types.make_medium(d, albedo, scale=40.0,
                                               max_density=1.0, device=cuda))
    settings = settings or types.RenderSettings.from_flags(True)
    ctx = fastq.make_context(scene, make_camera(tw, th, device=cuda), settings,
                             (tw, th), torch.tensor([2.0, 1.0], device=cuda),
                             (tw + 4, th + 2), 3 * tw * th, 9, 5, two_level)
    accum = torch.zeros((tw * th, 3), device=cuda)
    return ctx, fastq.initial_state(width, 9, cuda), accum


def fastq_mismatches(a, b):
    """The fields and counters of two fastQ states that differ bit for bit."""
    from cudavolumerenderer_tpu_torch.ops import fastqbody
    from cudavolumerenderer_tpu_torch.ops.stages import lane_field

    bad = []
    for n in fastqbody.LANE_FIELDS:
        x, y = lane_field(a, n), lane_field(b, n)
        if x.dtype == torch.float32:
            x, y = x.view(torch.int32), y.view(torch.int32)
        if not torch.equal(x, y):
            bad.append(n)
    for n in ("paths_issued", "n_rays", "n_iters", "n_busy"):
        x, y = getattr(a, n), getattr(b, n)
        if x.dtype == torch.float32:
            x, y = x.view(torch.int32), y.view(torch.int32)
        if x.item() != y.item():
            bad.append(n)
    return bad


FASTQ_ITS = {"refill": 8, "flush": 7, "step": 9, "drain-period": None}


@pytest.mark.cuda
@pytest.mark.parametrize("two_level", [False, True], ids=["one", "two"])
@pytest.mark.parametrize("width", [576, 1600])
@pytest.mark.parametrize("when", list(FASTQ_ITS))
def test_fastq_evaluation_equals_eager(cuda, when, width, two_level):
    """One body_kernel launch equals one eager iteration in every lane
    field, paths_issued, n_rays, n_iters and n_busy bit for bit, the image
    to float-summation order: at a refill iteration (the look-back's
    ranks), a periodic flush, an ordinary step and, once every path is
    issued, an iteration that flushes every lane."""
    from cudavolumerenderer_tpu_torch.models import fastq
    from cudavolumerenderer_tpu_torch.ops import fastqbody

    ctx, s, accum = fastq_setup(cuda, width, two_level)
    it = FASTQ_ITS[when]
    n = it if it is not None else 0
    for e in range(n):
        s = fastq.plain_body(ctx, s, accum, e)
    if it is None:
        while int(s.paths_issued) < ctx.n_paths:
            s = fastq.plain_body(ctx, s, accum, n)
            n += 1
        it = n
    a_acc, b_acc = accum.clone(), accum.clone()
    before = fastqbody.KERNEL.launches
    got = fastqbody.run_body(ctx, fastqbody.own(s), a_acc, it)
    want = fastq.plain_body(ctx, fastqbody.own(s), b_acc, it)
    torch.cuda.synchronize()
    assert fastqbody.KERNEL.launches == before + 1
    assert not fastq_mismatches(got, want)
    torch.testing.assert_close(a_acc, b_acc, rtol=1e-5, atol=1e-6)


FASTQ_SETTINGS = {
    "default": dict(),
    "null-no-rr": dict(bsdf_kind="null", russian_roulette=False),
}


@pytest.mark.cuda
@pytest.mark.parametrize("settings", list(FASTQ_SETTINGS))
@pytest.mark.parametrize("two_level", [False, True], ids=["one", "two"])
@pytest.mark.parametrize("cap", [8192, 5])
def test_fastq_drain_equals_eager_loop(cuda, cap, two_level, settings):
    """From the iteration at which every path is issued, the drain (each
    lane to its end in registers; relaunched at a lowered cap) equals the
    eager loop in every lane field and counter bit for bit, and its trip
    count is the loop's; GGX with RR, and the null BSDF without."""
    from cudavolumerenderer_tpu_torch.models import fastq
    from cudavolumerenderer_tpu_torch.ops import fastqbody
    from cudavolumerenderer_tpu_torch.ops.stages import C_TOTAL

    ctx, s, accum = fastq_setup(cuda, 1600, two_level,
                                settings=types.RenderSettings.from_flags(
                                    True, **FASTQ_SETTINGS[settings]))
    e0 = 0
    while int(s.paths_issued) < ctx.n_paths:
        s = fastq.plain_body(ctx, s, accum, e0)
        e0 += 1
    want, it, b_acc = fastqbody.own(s), e0, accum.clone()
    while bool(fastq.more(ctx, want)):
        want = fastq.plain_body(ctx, want, b_acc, it)
        it += 1
    got, a_acc = fastqbody.own(s), accum.clone()
    counts = torch.stack([got.n_rays, got.n_iters, got.n_busy])
    launches = fastqbody.KERNEL.drain_launches
    words = fastqbody.KERNEL.drain_stage(ctx, got, a_acc, counts, e0, cap)
    got = got._replace(n_rays=counts[0], n_iters=counts[1], n_busy=counts[2])
    assert words[C_TOTAL] == it == int(want.n_iters)
    assert fastqbody.KERNEL.drain_launches - launches >= (1 if cap > 8 else 2)
    assert not fastq_mismatches(got, want)
    torch.testing.assert_close(a_acc, b_acc, rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("albedo", ["affine", "const", "full"])
@pytest.mark.parametrize("two_level", [False, True], ids=["one", "two"])
@pytest.mark.parametrize("width", [576, 1600])
def test_fastq_render_kernels_equal_eager(cuda, width, two_level, albedo):
    """render_tile through the kernels (gated chains, then the drain) gives
    the eager loop's n_rays, n_iters and n_busy bit for bit and its image
    to float-summation order, with no eager iteration; the eager render
    launches nothing.  A constant, an affine and a 'full' albedo table."""
    from cudavolumerenderer_tpu_torch.models import fastq
    from cudavolumerenderer_tpu_torch.ops import fastqbody

    d = procedural.blob_volume()
    alb = {"affine": None, "const": (0.8, 0.6, 0.9),
           "full": np.random.RandomState(3).rand(*d.shape, 3).astype(
               np.float32)}[albedo]
    ctx, _, _ = fastq_setup(cuda, width, two_level, albedo=alb)
    tw, th = ctx.tile_dim
    args = (ctx.scene, ctx.camera, ctx.settings, (tw, th), ctx.tile_offset,
            ctx.full_resolution, 3, 9, 5)
    kw = dict(n_lanes=width // 2 + 7, two_level=two_level, with_stats=True)
    out = {}
    for eager in (False, True):
        fastqbody.KERNEL.reset()
        out[eager] = fastq.render_tile(*args, eager_body=eager, **kw)
        k = fastqbody.KERNEL
        out[eager, "counts"] = (k.launches + k.drain_launches, k.plain_evals,
                                k.evals)
    (a, *ca), (b, *cb) = out[False], out[True]
    launches, plain, evals = out[False, "counts"]
    assert launches > 0 and plain == 0
    assert out[True, "counts"][0] == 0
    assert evals == out[True, "counts"][2] == int(cb[1])
    for x, y in zip(ca, cb):
        assert x.item() == y.item()
    torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("two_level", [False, True], ids=["one", "two"])
def test_fastq_white_furnace_through_kernels(cuda, two_level):
    """Null BSDF, albedo 1: every pixel exactly spp through the kernels."""
    from cudavolumerenderer_tpu_torch.models import fastq
    from cudavolumerenderer_tpu_torch.ops import fastqbody

    settings = types.RenderSettings.from_flags(True, bsdf_kind="null")
    ctx, _, _ = fastq_setup(cuda, 576, two_level, settings=settings,
                            albedo=1.0)
    fastqbody.KERNEL.reset()
    img, _ = fastq.render_tile(ctx.scene, ctx.camera, settings, (24, 24),
                               torch.zeros(2, device=cuda), (24, 24), 2, 9, 0,
                               n_lanes=300, two_level=two_level)
    assert fastqbody.KERNEL.plain_evals == 0
    assert fastqbody.KERNEL.launches + fastqbody.KERNEL.drain_launches > 0
    assert torch.equal(img / 2, torch.ones_like(img))


@pytest.mark.cuda
def test_fastq_wrapper_runs_kernel_or_raises(cuda, monkeypatch):
    """run_body launches body_kernel (counted) and writes the `out` state
    it is given, leaving the input; a wrong dtype raises; a failed build
    raises out of the render, with no fallback to the eager body."""
    from cudavolumerenderer_tpu_torch.models import fastq
    from cudavolumerenderer_tpu_torch.ops import fastqbody
    from cudavolumerenderer_tpu_torch.utils import cuda_build

    ctx, s, accum = fastq_setup(cuda, 576, True)
    for e in range(6):
        s = fastq.plain_body(ctx, s, accum, e)
    src, out = fastqbody.own(s), fastqbody.own(s)
    before = fastqbody.KERNEL.launches
    got = fastqbody.run_body(ctx, src, accum.clone(), 6, out=out)
    assert fastqbody.KERNEL.launches == before + 1
    assert got.o.data_ptr() == out.o.data_ptr()
    assert not fastq_mismatches(src, s)
    want = fastq.plain_body(ctx, fastqbody.own(s), accum.clone(), 6)
    assert not fastq_mismatches(got, want)
    with pytest.raises(ValueError, match="throughput must be"):
        fastqbody.run_body(ctx, s._replace(throughput=s.throughput.double()),
                           accum, 6)

    def broken(source):
        raise RuntimeError("nvcc failed on fastqbody.cu")

    monkeypatch.setattr(fastqbody, "KERNEL", fastqbody.FastQKernel())
    monkeypatch.setattr(cuda_build, "build_library", broken)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        fastq.render_tile(ctx.scene, ctx.camera, ctx.settings, (24, 24),
                          torch.zeros(2, device=cuda), (24, 24), 1, 9, 0,
                          n_lanes=64)
    assert fastqbody.KERNEL.plain_evals == 0


# -- brickSK's round kernels (csrc/brickbody.cu) ---------------------------------------

# (tile w, h, lanes per pixel, scene): 1,920 lanes in 15 rows (no power of
# two), the slice's 160,000 lanes, two lanes per pixel, a 'full' albedo grid
BRICK_CASES = {
    "48x40": (48, 40, 1, "smoke"), "400x400": (400, 400, 1, "smoke"),
    "48x40-m2": (48, 40, 2, "smoke"), "48x40-full": (48, 40, 1, "full"),
}
BRICK_KEPT = (0, 3, 40)  # rounds run before the kept state


def brick_scene(kind, device):
    """The brickSK slice's smoke (128x128x50, albedo 0.9 d: affine, scale
    800), or a random 20x33x17 density with an independent per-voxel
    albedo ('full'), a non-cube box and g = 0.3."""
    if kind == "smoke":
        d = procedural.smoke_volume((128, 128, 50))
        alb = np.stack([d, d, d], axis=-1) * 0.9
        medium = types.make_medium(d, alb, scale=800.0,
                                   max_density=float(d.max()), device=device)
    else:
        rs = np.random.RandomState(4)
        d = rs.rand(20, 33, 17).astype(np.float32)
        alb = rs.rand(20, 33, 17, 3).astype(np.float32)
        medium = types.make_medium(
            d, alb, box_min=(-0.5, -0.4, -0.6), box_max=(0.6, 0.5, 0.4),
            scale=20.0, max_density=1.0, g=0.3, device=device)
    return types.make_scene(medium)


def brick_ctx(cuda, case, spp=4):
    tw, th, m, kind = BRICK_CASES[case]
    scene = brick_scene(kind, cuda)
    return brick.make_context(
        scene, make_camera(tw, th, device=cuda), types.RenderSettings(),
        (tw, th), torch.zeros(2, device=cuda), (tw, th), spp, 5, 7,
        lanes_per_pixel=m)


def brick_mismatches(a, b):
    from cudavolumerenderer_tpu_torch.ops import brickbody, stages

    bad = []
    for n in brickbody.STATE_FIELDS:
        x, y = stages.lane_field(a, n), stages.lane_field(b, n)
        if x.dtype == torch.float32:
            x, y = x.view(torch.int32), y.view(torch.int32)
        if not torch.equal(x, y):
            bad.append(n)
    return bad


@pytest.mark.cuda
@pytest.mark.parametrize("kept", BRICK_KEPT)
@pytest.mark.parametrize("case", list(BRICK_CASES))
def test_brick_kernels_equal_plain_versions(cuda, case, kept):
    """On a state kept after `kept` kernel rounds: phase_a_kernel against
    the eager phase A in this layout (every lane field, the keys, perm,
    n_rays, the count), then the round kernel against the eager tracking
    round on the sorted keys (every lane field, pos), bit for bit; each
    launch counted."""
    from cudavolumerenderer_tpu_torch.ops import brickbody as bb

    ctx = brick_ctx(cuda, case)
    s, pos = bb.own(brick.initial_state(ctx)), torch.arange(
        ctx.n_lanes, device=cuda)
    bufs = bb.RoundBuffers.make(ctx.n_lanes, cuda)
    for _ in range(kept):
        s, pos = bb.one_round(ctx, s, pos, bufs)
    before = dict(bb.KERNEL.by_op)
    got, keys, perm, count = bb.phase_a(ctx, bb.own(s), pos.clone(), bufs)
    want, wkeys, wperm, wcount = bb.plain_phase_a(ctx, bb.own(s), pos)
    torch.cuda.synchronize()
    assert bb.KERNEL.by_op["phase_a"] == before["phase_a"] + 1
    assert not brick_mismatches(got, want)
    assert got.n_rays.view(torch.int32) == want.n_rays.view(torch.int32)
    assert torch.equal(keys, wkeys) and torch.equal(perm, wperm)
    assert int(count) == int(wcount)
    bufs.sort()
    got_r, got_pos = bb.round_(ctx, bb.own(want), pos.clone(), bufs)
    want_r, want_pos = bb.plain_round(ctx, bb.own(want), pos, bufs.perm,
                                      bufs.skeys, bufs.order)
    torch.cuda.synchronize()
    assert bb.KERNEL.by_op["round"] == before["round"] + 1
    assert not brick_mismatches(got_r, want_r)
    assert torch.equal(got_pos, want_pos)
    if kept == BRICK_KEPT[-1]:
        assert bool((bufs.skeys != bb.SENTINEL).any())  # lanes tracked


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["48x40", "48x40-m2", "48x40-full",
                                  "400x400"])
def test_brick_render_through_kernels_equals_eager(cuda, case):
    """render_tile through the round kernels (gated batches) gives the
    eager loop's image bit for bit, its n_rays and its rounds, with one
    host read per batch of rounds and no tracking-kernel launch."""
    from cudavolumerenderer_tpu_torch.ops import brickbody as bb

    tw, th, m, kind = BRICK_CASES[case]
    scene = brick_scene(kind, cuda)
    spp = 1 if case == "400x400" else 4
    args = (scene, make_camera(tw, th, device=cuda), types.RenderSettings(),
            (tw, th), torch.zeros(2, device=cuda), (tw, th), spp, 5, 7)
    bb.KERNEL.reset()
    track = tracking.KERNEL.launches
    img, n_rays, rounds = brick.render_tile(*args, lanes_per_pixel=m,
                                            with_stats=True)
    torch.cuda.synchronize()
    assert tracking.KERNEL.launches == track
    launches, reads = dict(bb.KERNEL.by_op), bb.KERNEL.reads
    want_img, want_rays, want_rounds = brick.render_tile(
        *args, lanes_per_pixel=m, with_stats=True, eager_body=True)
    assert rounds == want_rounds > 0
    assert float(n_rays) == float(want_rays)
    assert torch.equal(img, want_img)
    assert launches["phase_a"] == launches["round"] >= rounds
    assert reads <= rounds // 32 + 2


@pytest.mark.cuda
def test_brick_white_furnace_through_kernels(cuda):
    """albedo 1, the null boundary, no roulette: every pixel exactly spp
    through the round kernels (a constant albedo)."""
    from cudavolumerenderer_tpu_torch.ops import brickbody as bb

    d = procedural.blob_volume((24, 24, 24), n_blobs=3)
    scene = types.make_scene(types.make_medium(d, 1.0, scale=8.0,
                                               max_density=1.0, device=cuda))
    settings = types.RenderSettings.from_flags(
        True, russian_roulette=False, bsdf_kind="null")
    bb.KERNEL.reset()
    img, _, rounds = brick.render_tile(
        scene, make_camera(16, 16, device=cuda), settings, (16, 16),
        torch.zeros(2, device=cuda), (16, 16), 2, 3, 0, with_stats=True)
    assert bb.KERNEL.by_op["round"] >= rounds > 1
    np.testing.assert_array_equal(img.cpu().numpy(), 2.0)


@pytest.mark.cuda
def test_brick_wrapper_runs_kernel_or_raises(cuda, monkeypatch):
    """The wrappers write the `out` state they are given (out of place, as
    the timing graphs use them) and equal the in-place launch; a wrong
    dtype raises; a failed build raises out of render_tile, with no
    fallback to the eager loop."""
    from cudavolumerenderer_tpu_torch.ops import brickbody as bb
    from cudavolumerenderer_tpu_torch.utils import cuda_build

    ctx = brick_ctx(cuda, "48x40")
    s, pos = bb.own(brick.initial_state(ctx)), torch.arange(
        ctx.n_lanes, device=cuda)
    bufs = bb.RoundBuffers.make(ctx.n_lanes, cuda)
    for _ in range(5):
        s, pos = bb.one_round(ctx, s, pos, bufs)
    out, pos_out = bb.own(s), torch.empty_like(pos)
    got, *_ = bb.phase_a(ctx, s, pos, bufs, out=out, pos_out=pos_out)
    assert got.o.data_ptr() == out.o.data_ptr()
    assert torch.equal(pos_out, pos)
    want, *_ = bb.phase_a(ctx, bb.own(s), pos.clone(), bufs)
    assert not brick_mismatches(got, want)
    with pytest.raises(ValueError, match="throughput must be"):
        bb.phase_a(ctx, s._replace(throughput=s.throughput.double()), pos,
                   bufs)

    def broken(source):
        raise RuntimeError("nvcc failed on brickbody.cu")

    monkeypatch.setattr(bb, "KERNEL", bb.BrickBodyKernel())
    monkeypatch.setattr(cuda_build, "build_library", broken)
    track = tracking.KERNEL.launches
    with pytest.raises(RuntimeError, match="nvcc failed"):
        brick.render_tile(ctx.scene, ctx.camera, ctx.settings, ctx.tile_dim,
                          torch.zeros(2, device=cuda), ctx.full_resolution,
                          4, 5, 7)
    assert tracking.KERNEL.launches == track
    assert sum(bb.KERNEL.plain_evals.values()) == 0


# -- the bounce-lockstep replays (csrc/nestedreplay.cu) -------------------------

#: (id, two-level, bsdf, Russian roulette, mitsuba_comparable (trilinear and
#: Mitsuba's GGX sampler; else nearest and Heitz's), a constant albedo)
NESTED_CASES = [
    ("1l-ggx-voxel-rr", False, "ggx", True, True, False),
    ("1l-null-const-nearest", False, "null", False, False, True),
    ("1l-ggx-const", False, "ggx", False, True, True),
    ("2l-ggx-const-rr", True, "ggx", True, True, True),
    ("2l-null-voxel-heitz", True, "null", False, False, False),
]
#: pools that powers of two cannot stand in for (the card's float rules)
NESTED_RES = [24, 40]
NESTED_FIELDS = ("o", "d", "throughput", "radiance", "alive")


def nested_problem(device, two, bsdf, rr, mitsuba, const_albedo, res, spp=1,
                   albedo_value=0.7, max_path=64):
    """The 32^3 blob volume of replay_problem (scale 12), the camera's lanes
    at res^2 x spp and pass B's weights made with numpy from a seed:
    (scene, settings, tables, (o0, d0, rng, s_lane, g_lane))."""
    d = procedural.medical_volume((32,) * 3, n_blobs=6).astype(np.float32)
    rs = np.random.RandomState(3)
    alb = (np.full((1, 1, 1, 4), albedo_value, np.float32) if const_albedo
           else (0.3 + 0.6 * rs.rand(32, 32, 32, 4)).astype(np.float32))
    scene = differentiable.SceneSpec(scale=12.0).build(d, alb, device)
    cam = differentiable.CameraSpec(res_x=res, res_y=res,
                                    fov_x_deg=0.8).build(device)
    settings = types.RenderSettings.from_flags(
        mitsuba, russian_roulette=rr, max_path_length=max_path,
        bsdf_kind=bsdf)
    n, _, o0, d0, rng = differentiable._lane_setup(cam, (res, res), spp, 5)
    g = torch.tensor(rs.rand(n, 3).astype(np.float32), device=device)
    tables = (differentiable._build_brick_tab(scene.medium.density.data)
              if two else None)
    return scene, settings, tables, (o0, d0, rng, torch.sum(g, dim=-1), g)


def nested_pass(problem, record, eager, device):
    """One replay through the kernels (eager=False) or the eager loop:
    (the _ReplayState, d_density, d_albedo)."""
    scene, settings, tables, (o0, d0, rng, s, g) = problem
    dd, da = cotangents(scene, device)
    out = differentiable._replay(scene, settings, o0, d0, rng, s, g, record,
                                 dd, da, tables, fused=False,
                                 eager_body=eager)
    return out, dd, da


def nested_mismatches(a, b):
    bad = [k for k in NESTED_FIELDS
           if not torch.equal(getattr(a, k), getattr(b, k))]
    return bad + (["rng"] if not torch.equal(a.rng.state, b.rng.state)
                  else [])


@pytest.mark.cuda
@pytest.mark.parametrize("res", NESTED_RES, ids=[f"{r}^2" for r in NESTED_RES])
@pytest.mark.parametrize("case", NESTED_CASES, ids=[c[0] for c in NESTED_CASES])
def test_nested_replay_kernel_equals_eager_loop(cuda, case, res):
    """The whole replay through csrc/nestedreplay.cu against the eager loop
    on the card, at 24^2 and 40^2 lanes: pass A (the drain) and pass B in
    every lane field bit for bit; pass B's cotangents within GRAD_* with
    atomics (the drain and index_add_ both add with atomics, in other
    orders) and bit for bit under deterministic algorithms (the lockstep
    launches, their records added by index_add_ in the eager order)."""
    from cudavolumerenderer_tpu_torch.ops import nestedreplay

    problem = nested_problem(cuda, *case[1:], res)
    k = nestedreplay.KERNEL
    for record in (False, True):
        want, de, ae = nested_pass(problem, record, True, cuda)
        before = (k.drain_launches, k.plain_passes)
        got, dk, ak = nested_pass(problem, record, False, cuda)
        assert (k.drain_launches, k.plain_passes) == (before[0] + 1,
                                                      before[1])
        assert not nested_mismatches(got, want), record
        if record:
            assert float(de.abs().max()) > 0 and float(ae.abs().max()) > 0
            assert_grads_close(dk, de)
            assert_grads_close(ak, ae)
        else:
            assert not dk.any() and not ak.any()
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        want, de, ae = nested_pass(problem, True, True, cuda)
        launches = k.launches
        got, dk, ak = nested_pass(problem, True, False, cuda)
    finally:
        torch.use_deterministic_algorithms(was)
    assert k.launches > launches
    assert not nested_mismatches(got, want)
    assert torch.equal(dk, de) and torch.equal(ak, ae)


@pytest.mark.cuda
def test_white_furnace_through_nested_replay(cuda):
    """Albedo 1, the null BSDF, no roulette: every path leaves the box with
    throughput 1, so pass A's radiance (the drain) sums to spp in every
    pixel exactly."""
    from cudavolumerenderer_tpu_torch.ops import nestedreplay

    res, spp = 24, 4
    problem = nested_problem(cuda, False, "null", False, True, True, res,
                             spp, albedo_value=1.0, max_path=1 << 20)
    drains = nestedreplay.KERNEL.drain_launches
    out, _, _ = nested_pass(problem, False, False, cuda)
    assert nestedreplay.KERNEL.drain_launches == drains + 1
    assert not bool(out.alive.any())
    image_id = torch.arange(res * res * spp, device=cuda) % (res * res)
    img = torch.zeros((res * res, 3), device=cuda).index_add_(
        0, image_id, out.radiance)
    assert torch.equal(img, torch.full_like(img, float(spp)))


@pytest.mark.cuda
def test_one_level_backward_never_reaches_the_eager_loop(cuda, monkeypatch):
    """render_diff's one-level backward on the card runs pass A and pass B
    as two drain launches (under deterministic algorithms pass B as
    lockstep launches) and no eager replay; a failed build raises out of it,
    with no fallback to the eager loop."""
    from cudavolumerenderer_tpu_torch.ops import nestedreplay
    from cudavolumerenderer_tpu_torch.utils import cuda_build

    def backward():
        density, albedo = (procedural.medical_volume((16,) * 3, n_blobs=4)
                           .astype(np.float32),
                           np.full((1, 1, 1, 4), 0.6, np.float32))
        d = torch.tensor(density, device=cuda, requires_grad=True)
        img = differentiable.render_diff(
            d, torch.tensor(albedo, device=cuda), 3,
            differentiable.SceneSpec(scale=12.0),
            differentiable.CameraSpec(res_x=16, res_y=16, fov_x_deg=0.8),
            types.RenderSettings.from_flags(True, russian_roulette=False,
                                            max_path_length=64),
            (16, 16), 2)
        img.sum().backward()
        return d.grad

    k = nestedreplay.KERNEL
    before = (k.drain_launches, k.launches, k.plain_passes, k.plain_reads)
    grad = backward()
    assert torch.isfinite(grad).all() and float(grad.abs().max()) > 0
    assert (k.drain_launches, k.launches, k.plain_passes, k.plain_reads) == (
        before[0] + 2, before[1], before[2], before[3])
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        grad_det = backward()
    finally:
        torch.use_deterministic_algorithms(was)
    assert k.drain_launches == before[0] + 3 and k.launches > before[1]
    assert k.plain_passes == before[2]
    torch.testing.assert_close(grad_det, grad, rtol=GRAD_RTOL,
                               atol=GRAD_ATOL * float(grad.abs().max()))

    def broken(source):
        raise RuntimeError("nvcc failed on nestedreplay.cu")

    monkeypatch.setattr(nestedreplay, "KERNEL",
                        nestedreplay.NestedReplayKernel())
    monkeypatch.setattr(cuda_build, "build_library", broken)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        backward()
    assert nestedreplay.KERNEL.plain_passes == 0
