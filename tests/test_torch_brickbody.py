"""brickSK's round kernels (csrc/brickbody.cu, ops/brickbody.py) on the
CPU, which has no card.

On the card brickSK's rounds run as phase A, torch's stable sort and the
tracking round, with the lanes kept in place and carrying their sorted
position.  Here: the runner in that layout with the plain versions
against the parent's permuting loop (transcribed below) bit for bit in
image, n_rays, rounds and every lane field through perm, at 16^2 x 2 and
with two lanes per pixel (a lane's slot is its position's), on the smoke
scene with GGX and with the null boundary; one round by the wrappers
against one eager round; a finished state a fixed point of a round; the
parameter vectors and pointer slots against the C layout and the values
the eager functions read; the bound's byte count; and the routing.  The
kernels against their plain versions, bit for bit, are in
tests/test_torch_cuda.py (card tests).
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from cudavolumerenderer_tpu_torch.models import brick, fast
from cudavolumerenderer_tpu_torch.ops import brickbody as bb
from cudavolumerenderer_tpu_torch.ops import camera as tcam
from cudavolumerenderer_tpu_torch.ops import stages
from cudavolumerenderer_tpu_torch.scene import procedural
from cudavolumerenderer_tpu_torch.scene import types as ttypes
from test_torch_fastbody import enum_values

torch.set_num_threads(2)

SOURCE = Path(bb.__file__).resolve().parents[1] / "csrc" / "brickbody.cu"
COMMON = SOURCE.parent / "common.cuh"


def smoke_context(res=16, spp=2, m=1, bsdf="ggx", rr=True, seed=5, base=0):
    """A brickSK context on the smoke volume (32x32x16, albedo 0.9 d,
    scale 800) at res x res."""
    d = procedural.smoke_volume((32, 32, 16))
    alb = np.stack([d, d, d], axis=-1) * 0.9
    scene = ttypes.make_scene(ttypes.make_medium(
        d, alb, scale=800.0, max_density=float(d.max()), device="cpu"))
    settings = ttypes.RenderSettings.from_flags(True, bsdf_kind=bsdf,
                                                russian_roulette=rr)
    camera = tcam.make_camera(res, res, device="cpu")
    return brick.make_context(scene, camera, settings, (res, res),
                              torch.zeros(2), (res, res), spp, seed, base,
                              lanes_per_pixel=m)


# -- the parent's loop, transcribed -------------------------------------------------

def parent_loop(ctx):
    """The parent's brick.render_tile loop: phase A, the keys, one stable
    argsort, the whole state permuted by it, the tracking round; the
    condition read on the host each round.  Returns (image, final state in
    sorted order, rounds)."""
    state, rounds = brick.initial_state(ctx), 0
    while bool(torch.any(state.alive
                         | (state.samples_done < ctx.spp_per_lane))):
        s = brick.phase_a(ctx, state)
        keys = brick.round_keys(ctx, s)
        order = torch.argsort(keys, stable=True)
        state = brick.track_rows(ctx, fast._take_lanes(s, order), keys[order])
        rounds += 1
    img = torch.zeros((ctx.n_pix, 3))
    img.index_add_(0, state.pix, state.accum)
    return img, state, rounds


def field_mismatches(a, b):
    """The BrickState fields (the RNG's two words split) that differ bit
    for bit, NaN equal to NaN."""
    bad = []
    for n in bb.STATE_FIELDS:
        x, y = stages.lane_field(a, n), stages.lane_field(b, n)
        if x.dtype == torch.float32:
            x, y = x.view(torch.int32), y.view(torch.int32)
        if not torch.equal(x, y):
            bad.append(n)
    if a.n_rays.view(torch.int32) != b.n_rays.view(torch.int32):
        bad.append("n_rays")
    return bad


@pytest.mark.parametrize("m,bsdf,rr", [(1, "ggx", True), (2, "ggx", True),
                                       (1, "null", True)])
def test_runner_equals_the_parents_loop(m, bsdf, rr):
    """run_rounds' plain bookkeeping (the lanes in place, pos and perm) is
    the permuting loop: every lane field through perm, n_rays, rounds and
    the image bit for bit; render_tile on the CPU gives the same."""
    ctx = smoke_context(m=m, bsdf=bsdf, rr=rr)
    want_img, want, want_rounds = parent_loop(ctx)
    got, pos, rounds = bb.run_rounds(ctx, brick.initial_state(ctx),
                                     kernel=False)
    assert rounds == want_rounds > 10
    assert sorted(pos.tolist()) == list(range(ctx.n_lanes))
    assert not field_mismatches(fast._take_lanes(got, bb.perm_of(pos)), want)
    img, n_rays, r = brick.render_tile(
        ctx.scene, ctx.camera, ctx.settings, ctx.tile_dim, torch.zeros(2),
        ctx.full_resolution, ctx.spp_per_lane * ctx.m, 5, 0,
        lanes_per_pixel=m, with_stats=True)
    assert r == rounds and float(n_rays) == float(want.n_rays) > 0
    assert torch.equal(img.reshape(-1, 3), want_img)


def test_lane_slot_is_its_position():
    """With two lanes per pixel a lane that moves to the other half of the
    positions takes the other slot's path ids; the runner follows its
    position, as the parent's loop does (checked above), so its pos must
    move lanes across halves in this render."""
    ctx = smoke_context(m=2)
    _, pos, _ = bb.run_rounds(ctx, brick.initial_state(ctx), kernel=False)
    lane = torch.arange(ctx.n_lanes)
    assert bool(((pos // ctx.n_pix) != (lane // ctx.n_pix)).any())


def test_one_round_by_the_wrappers_equals_an_eager_round():
    """phase_a, the sort and round_ on CPU tensors (the plain versions) give
    the eager round, on a state some rounds into the render with its lanes
    out of their positions."""
    ctx = smoke_context()
    state, pos = brick.initial_state(ctx), torch.arange(ctx.n_lanes)
    for _ in range(6):
        state, pos = bb.one_round(ctx, state, pos, bb.RoundBuffers.make(
            ctx.n_lanes, "cpu"))
    sp = fast._take_lanes(state, bb.perm_of(pos))
    want = brick.kernel_round(ctx, brick.phase_a(ctx, sp))
    got, pos2 = bb.one_round(ctx, state, pos, bb.RoundBuffers.make(
        ctx.n_lanes, "cpu"))
    assert not field_mismatches(fast._take_lanes(got, bb.perm_of(pos2)), want)


def test_finished_state_is_a_fixed_point():
    """Once no lane is alive or has samples left, a round changes no lane
    field, no position and not n_rays (every key is the sentinel, so the
    stable sort is the identity)."""
    ctx = smoke_context()
    s, pos, _ = bb.run_rounds(ctx, brick.initial_state(ctx), kernel=False)
    assert int(brick.pending_count(ctx, s)) == 0
    got, keys, perm, count = bb.plain_phase_a(ctx, s, pos)
    assert int(count) == 0 and bool((keys == bb.SENTINEL).all())
    assert not field_mismatches(got, s)
    got2, pos2 = bb.one_round(ctx, s, pos, bb.RoundBuffers.make(
        ctx.n_lanes, "cpu"))
    assert not field_mismatches(got2, s) and torch.equal(pos2, pos)


def test_kernel_keys_sort_as_the_eager_keys():
    """The kernel's int32 keys (sentinel 2^31 - 1) give the stable order of
    the eager loop's int64 keys (sentinel 2^32 - 1)."""
    rs = np.random.RandomState(3)
    keys = torch.tensor(rs.randint(0, 50, 4096))
    keys[rs.rand(4096) < 0.4] = brick._SENTINEL
    k32 = bb.to_kernel_keys(keys)
    assert k32.dtype == torch.int32
    assert torch.equal(torch.sort(k32, stable=True)[1],
                       torch.argsort(keys, stable=True))


def test_kernel_layout_equals_the_wrappers():
    """csrc/brickbody.cu's FP_*, IP_*, S_*, OP_* and SC_* enums give the
    values ops/brickbody.py packs by, its constants the wrapper's, and
    common.cuh's fused layouts and albedo modes the wrapper's."""
    text = SOURCE.read_text()
    c = enum_values(text)
    py = {k: v for k, v in vars(bb).items()
          if re.fullmatch(r"(FP|IP|S|N)_[A-Z0-9_]+", k) and isinstance(v, int)
          and k != "N_CTRL"}
    lane = {f"S_{n}": k for k, n in enumerate(
        ("O", "D", "TP", "ACC", "NRM", "BASE", "T", "MAXT", "BEXIT", "ISIG",
         "PIX", "SD", "STATUS", "ALIVE", "TRACKING", "RS", "RINC", "POS"))}
    assert len(py) >= 60
    for name, value in py.items():
        assert c[name] == value, name
    for name, k in lane.items():
        assert c[name] == k, name
    assert [c[f"OP_{op.upper()}"] for op in bb.OPS] == [0, 1]
    assert c["N_SCRATCH"] == bb.N_SCRATCH
    assert f"SENTINEL = {bb.SENTINEL:#X}".replace("0X", "0x") in text
    assert f"MASKED = {bb.MASKED};" in text and bb.MASKED == brick.MASKED
    common = COMMON.read_text()
    assert (f"FUSED_F32 = {bb.FUSED_F32}, FUSED_ROWS = {bb.FUSED_ROWS}"
            in common)
    assert ("ALBEDO_CONST = {const}, ALBEDO_AFFINE = {affine}, "
            "ALBEDO_ROW = {full}").format(**bb.ALBEDO_MODES) in common
    assert "C_EVAL = 0, C_COUNT" in common


def test_parameters_are_the_eager_values():
    """The float vector holds the tensors the eager functions read (the
    box, the grid and brick extents, res_minus_1 / extent, epsw, the
    camera, the float32 reciprocals of the Python divisors), the integer
    one the grid, the bricks, the modes, the sample split and the hashed
    seed."""
    ctx = smoke_context(res=16, spp=4, m=2, seed=77, base=3)
    f, i = bb.params(ctx)
    med = ctx.scene.medium
    assert np.array_equal(f[bb.FP_BMIN:bb.FP_BMIN + 3], med.box_min.numpy())
    assert np.array_equal(f[bb.FP_VOXS:bb.FP_VOXS + 3],
                          (ctx.res_minus_1 / ctx.extent).numpy())
    assert np.array_equal(f[bb.FP_BSIZE:bb.FP_BSIZE + 3], [8.0, 4.0, 4.0])
    assert f[bb.FP_EPSW] == np.float32(ctx.epsw)
    assert f[bb.FP_INV_TW] == np.float32(1.0) / np.float32(16)
    assert np.array_equal(f[bb.FP_CAM:bb.FP_CAM + 12],
                          ctx.camera.inv_view.reshape(-1).numpy())
    assert ctx.albedo_mode == "affine"
    assert np.array_equal(f[bb.FP_ALB_A:bb.FP_ALB_A + 3],
                          med.albedo_affine[0].numpy())
    nbz, nby, nbx = ctx.n_bricks_zyx
    assert list(i[[bb.IP_NX, bb.IP_NY, bb.IP_NZ]]) == [32, 32, 16]
    assert list(i[[bb.IP_NBX, bb.IP_NBY, bb.IP_NBZ]]) == [nbx, nby, nbz]
    assert i[bb.IP_NBRICKS] == ctx.n_bricks == ctx.bm_flat.numel()
    assert i[bb.IP_ALBEDO] == bb.ALBEDO_MODES["affine"]
    assert i[bb.IP_TABLE] == bb.FUSED_F32
    assert (i[bb.IP_SPP], i[bb.IP_M], i[bb.IP_NPIX]) == (2, 2, 256)
    assert i[bb.IP_BASE] == 3 and i[bb.IP_KSTEPS] == 8
    assert i[bb.IP_SEEDH] == (77 * 0x9E3779B9) & 0xFFFFFFFF
    assert i[bb.IP_BSDF] == 1 and i[bb.IP_RR] == 1


def test_brick_bytes_counts_lanes_and_distinct_words():
    """brick_bytes: the fields each lane reads and changes at their sizes,
    the bookkeeping bytes of each lane a key or an order covers, and each
    distinct fused, majorant and table word once."""
    ctx = smoke_context()
    yes, no = torch.tensor([True] * 3), torch.tensor([False] * 3)
    state = {"alive": (yes, torch.tensor([False, True, False])),
             "o": (torch.tensor([True, False, False]),) * 2,
             "accum": (no, no)}
    taps = [("state", state), ("keys", yes), ("fused", torch.tensor([3, 3])),
            ("major", torch.tensor([1, 2])), ("major", torch.tensor([2])),
            ("table", torch.tensor([7, 9, 7]))]
    lanes = 3 + 1 + 2 * 12
    assert bb.brick_bytes(ctx, taps) == (
        lanes + 3 * bb.KEYS_BYTES + 4 * 1 + 4 * 2 + 4 * 2)
    assert bb.brick_bytes(ctx, [("order", torch.tensor([True, False]))]) == (
        bb.ORDER_BYTES)


def test_plain_taps_give_a_bound():
    """The plain versions' taps on a round of the render: the lanes' reads
    and writes, keys and order for every lane, the scatters' fused words,
    the DDA's majorants and the steps' table words."""
    ctx = smoke_context()
    state, pos = brick.initial_state(ctx), torch.arange(ctx.n_lanes)
    for _ in range(4):
        state, pos = bb.one_round(ctx, state, pos, bb.RoundBuffers.make(
            ctx.n_lanes, "cpu"))
    taps_a, taps_r = [], []
    s, keys, perm, _ = bb.plain_phase_a(ctx, state, pos, taps=taps_a)
    skeys, order = torch.sort(keys, stable=True)
    bb.plain_round(ctx, s, pos, perm, skeys, order, taps=taps_r)
    kinds_a = {k for k, _ in taps_a}
    assert {"state", "keys", "major"} <= kinds_a
    assert {k for k, _ in taps_r} == {"state", "order", "table"}
    n = ctx.n_lanes
    assert bb.brick_bytes(ctx, taps_a) > n * (bb.KEYS_BYTES + 10)
    assert bb.brick_bytes(ctx, taps_r) >= n * bb.ORDER_BYTES


@pytest.mark.parametrize("dev,eager,want", [
    ("cpu", False, False), ("cuda", False, True), ("cuda", True, False),
    ("cpu", True, False),
])
def test_route(dev, eager, want):
    assert bb.route(dev, eager) is want


def test_wrappers_raise_off_the_cpu_and_the_card():
    """The wrappers run the plain versions on CPU tensors and the kernels
    on CUDA tensors; any other device raises (no fallback)."""
    ctx = smoke_context(res=16)

    def meta(v):
        if isinstance(v, torch.Tensor):
            return v.to("meta")
        return type(v)(*(meta(x) for x in v))

    s = meta(brick.initial_state(ctx))
    pos = torch.arange(ctx.n_lanes, device="meta")
    bufs = bb.RoundBuffers.make(ctx.n_lanes, "meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        bb.phase_a(ctx, s, pos, bufs)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        bb.round_(ctx, s, pos, bufs)
