"""The integrator family's body kernels (csrc/familybody.cu,
ops/familybody.py) on the CPU, which has no card.

naiveSK, naiveMK, regenerationSK, streamingSK, sortingSK and streamingMK now
run their loops through ops/familybody (the plain bodies on the CPU, the
kernels on the card).  Here: each new runner against the host loop it
replaced (the parent's loop around the same eager functions, transcribed
below) bit for bit in image, n_rays and evaluations, with regeneration's
groups of 1, 8 and 1,024 lanes and pools no multiple of the group; each row
against JAX's render_tile at 16^2 x 4 (n_rays exact, images to 1e-4, as
tests/test_torch_schedulers.py holds them: XLA's last bits); the drain's
n_rays fold (a histogram of the lanes' bounce counts folded in float32)
against the loop's sums, past 2^24 where float32 rounds; a dead lane a
fixed point of bounce_step and extend_step; the parameter vectors and
pointer slots against the C layout and the values the eager functions
read; the bound's byte count; and the routing.  The kernels against the
eager functions, bit for bit, are in tests/test_torch_cuda.py (card
tests).
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from cudavolumerenderer_tpu.models import naive as jnaive
from cudavolumerenderer_tpu.models import regeneration as jregen
from cudavolumerenderer_tpu.models import streaming as jstream
from cudavolumerenderer_tpu.models import wavefront_mk as jwmk
from cudavolumerenderer_tpu_torch.models import (
    integrator,
    naive,
    regeneration,
    streaming,
    wavefront_mk,
)
from cudavolumerenderer_tpu_torch.ops import familybody as fam
from cudavolumerenderer_tpu_torch.ops import rng, stages, woodcock
from cudavolumerenderer_tpu_torch.scene import types as ttypes
from test_torch_fastbody import enum_values
from test_torch_schedulers import JAX_TOL, args_pair

torch.set_num_threads(2)

SOURCE = Path(fam.__file__).resolve().parents[1] / "csrc" / "familybody.cu"
RES, SPP = 12, 2


# -- the parent's host loops, transcribed -----------------------------------------

def parent_naive(scene, camera, settings, tile_dim, tile_offset, res, spp,
                 seed, base):
    image_id, state = naive.start_batch(camera, tile_dim, tile_offset, res,
                                        spp, seed, base)
    bounce = 0
    while bounce < settings.max_path_length and bool(torch.any(state.alive)):
        state = integrator.bounce_step(scene, settings, state)
        bounce += 1
    return naive.splat(image_id, state.radiance, tile_dim), state.n_rays, bounce


def parent_naive_mk(scene, camera, settings, tile_dim, tile_offset, res, spp,
                    seed, base, compaction=True):
    image_id, state = naive.start_batch(camera, tile_dim, tile_offset, res,
                                        spp, seed, base)
    n = 0
    for _ in range(settings.max_path_length):
        state = integrator.bounce_step(scene, settings, state)
        n += 1
        if int(torch.sum(state.alive)) == 0:
            break
        if compaction:
            state, image_id = wavefront_mk._compact(state, image_id)
    return naive.splat(image_id, state.radiance, tile_dim), state.n_rays, n


def parent_regeneration(scene, camera, settings, tile_dim, tile_offset, res,
                        spp, seed, base, n_lanes, refill_group):
    tw, th = tile_dim
    n_paths = tw * th * spp
    n_lanes = min(n_lanes, n_paths)
    accum = torch.zeros((tw * th, 3))
    state = integrator.PathState(**regeneration.empty_pool(n_lanes, seed,
                                                           "cpu"))
    image_id = torch.zeros((n_lanes,), dtype=torch.int64)
    issued = torch.zeros((), dtype=torch.int64)
    n = 0
    while bool(torch.any(state.alive) | (issued < n_paths)):
        state, image_id, issued = regeneration._regenerate(
            state, image_id, issued, n_paths, tile_dim, tile_offset, res,
            camera, seed, base, refill_group=refill_group)
        was_alive = state.alive
        state = integrator.bounce_step(scene, settings, state)
        died = torch.logical_and(was_alive, torch.logical_not(state.alive))
        accum.index_add_(0, image_id,
                         torch.where(died[..., None], state.radiance, 0.0))
        state = state._replace(
            radiance=torch.where(died[..., None], 0.0, state.radiance))
        n += 1
    return accum.reshape(th, tw, 3), state.n_rays, n


def parent_streaming(scene, camera, settings, tile_dim, tile_offset, res,
                     spp, seed, base, n_lanes, sort_every=0,
                     defer_access=False, check_every=streaming.CHECK_EVERY):
    tw, th = tile_dim
    n_paths = tw * th * spp
    n_lanes = min(n_lanes, n_paths)
    med = scene.medium
    s = streaming.initial_stream_state(n_lanes, seed, "cpu")
    accum = torch.zeros((tw * th, 3))
    issued = torch.zeros((), dtype=torch.int64)
    it = 0
    while bool(torch.any(s.alive) | (issued < n_paths)):
        for _ in range(check_every):
            if sort_every > 0 and it % sort_every == 0:
                s = streaming._morton_reorder(s, med.box_min, med.box_max)
                if defer_access:
                    s, accum = streaming.flush_pending(scene, settings, s,
                                                       accum)
            s, issued = streaming._refill(s, issued, n_paths, tile_dim,
                                          tile_offset, res, camera, seed, base)
            s, accum = streaming.extend_step(scene, settings, s, accum,
                                             defer_albedo=defer_access)
            it += 1
    return accum.reshape(th, tw, 3), s.n_rays, it


def parent_streaming_mk(scene, camera, settings, tile_dim, tile_offset, res,
                        spp, seed, base, n_lanes, k_steps=8):
    tw, th = tile_dim
    n_paths = tw * th * spp
    n_lanes = min(n_lanes, n_paths)
    s = streaming.initial_stream_state(n_lanes, seed, "cpu")
    accum = torch.zeros((tw * th, 3))
    issued = torch.zeros((), dtype=torch.int64)
    n = 0
    while True:
        s, issued = streaming._refill(s, issued, n_paths, tile_dim,
                                      tile_offset, res, camera, seed, base)
        for _ in range(k_steps):
            s, accum = streaming.extend_step(scene, settings, s, accum)
        n += k_steps
        s = wavefront_mk._compact_stream(s)
        if int(torch.sum(s.alive)) == 0 and int(issued) >= n_paths:
            break
    return accum.reshape(th, tw, 3), s.n_rays, n


# the rows: (label, new runner, parent's loop, keywords)
RUNNERS = [
    ("naiveSK", naive.render_tile, parent_naive, {}),
    ("naiveMK", wavefront_mk.render_tile, parent_naive_mk, {}),
    ("naiveMK no compaction", wavefront_mk.render_tile, parent_naive_mk,
     {"compaction": False}),
    ("regenerationSK 0", regeneration.render_tile, parent_regeneration,
     {"n_lanes": 100, "refill_group": 1}),
    ("regenerationSK 1", regeneration.render_tile, parent_regeneration,
     {"n_lanes": 100, "refill_group": 8}),
    ("regenerationSK 1, 64 lanes", regeneration.render_tile,
     parent_regeneration, {"n_lanes": 64, "refill_group": 8}),
    ("regenerationSK 2", regeneration.render_tile, parent_regeneration,
     {"n_lanes": 288, "refill_group": 1024}),
    ("regenerationSK 2, 1,100 lanes", regeneration.render_tile,
     parent_regeneration, {"n_lanes": 1100, "refill_group": 1024}),
    ("streamingSK", streaming.render_tile, parent_streaming,
     {"n_lanes": 100}),
    ("sortingSK", streaming.render_tile, parent_streaming,
     {"n_lanes": 100, "sort_every": 8, "defer_access": True}),
    ("sorting every 3, no defer", streaming.render_tile, parent_streaming,
     {"n_lanes": 100, "sort_every": 3, "check_every": 4}),
    ("streamingMK", wavefront_mk.render_tile_streaming_mk,
     parent_streaming_mk, {"n_lanes": 64}),
]


@pytest.mark.parametrize("rr", [True, False], ids=["rr", "no-rr"])
@pytest.mark.parametrize("row", RUNNERS, ids=[r[0] for r in RUNNERS])
def test_runner_equals_parent_loop(row, rr):
    """The new runner on the CPU (stages.loop_chains or the drain's loop of
    the plain bodies) gives the parent's image and n_rays bit for bit, in
    the parent's evaluations (1,100 lanes at 24^2 x 2 paths: one group of
    1,024 and 76 lanes past it)."""
    label, runner, parent, kw = row
    t_args, _ = args_pair(res=RES, spp=SPP, rr=rr)
    if label.startswith("regenerationSK 2, 1,100"):
        t_args = list(t_args)
        t_args[3] = t_args[5] = (2 * RES, 2 * RES)
        t_args = tuple(t_args)
    want_img, want_rays, want_n = parent(*t_args, **kw)
    fam.KERNEL.reset()
    img, n_rays = runner(*t_args, **kw)
    assert torch.equal(img, want_img), label
    assert float(n_rays) == float(want_rays), label
    assert fam.KERNEL.evals == want_n, label
    assert fam.KERNEL.launches == fam.KERNEL.drain_launches == 0


def variable_args(res=RES, spp=SPP, rr=True):
    """args_pair's port and JAX arguments with the variable boundary
    (the isosurface march at the default threshold)."""
    from cudavolumerenderer_tpu.scene import types as jtypes

    t_args, j_args = args_pair(res=res, spp=spp, rr=rr)
    kw = dict(russian_roulette=rr, boundary="variable")
    return ((*t_args[:2], ttypes.RenderSettings.from_flags(True, **kw),
             *t_args[3:]),
            (*j_args[:2], jtypes.RenderSettings.from_flags(True, **kw),
             *j_args[3:]))


VARIABLE_ROWS = [r for r in RUNNERS if r[0] in (
    "naiveSK", "naiveMK", "regenerationSK 0", "regenerationSK 1",
    "streamingSK", "sortingSK", "streamingMK")]


@pytest.mark.parametrize("row", VARIABLE_ROWS, ids=[r[0] for r in
                                                    VARIABLE_ROWS])
def test_runner_equals_parent_loop_variable_boundary(row):
    """Under --boundary variable (the march inside bounce_step) each new
    runner on the CPU gives the parent loop's image and n_rays bit for bit
    in its evaluations: the routing no longer sends these rows elsewhere."""
    label, runner, parent, kw = row
    t_args, _ = variable_args()
    want_img, want_rays, want_n = parent(*t_args, **kw)
    fam.KERNEL.reset()
    img, n_rays = runner(*t_args, **kw)
    assert torch.equal(img, want_img), label
    assert float(n_rays) == float(want_rays), label
    assert fam.KERNEL.evals == want_n, label


VARIABLE_JAX_ROWS = [
    ("naiveSK", naive.render_tile, jnaive.render_tile, {}),
    ("naiveMK", wavefront_mk.render_tile, jwmk.render_tile, {}),
    ("regenerationSK 0", regeneration.render_tile, jregen.render_tile,
     {"n_lanes": 200, "refill_group": 1}),
    ("streamingSK", streaming.render_tile, jstream.render_tile,
     {"n_lanes": 200}),
    ("sortingSK", streaming.render_tile, jstream.render_tile,
     {"n_lanes": 200, "sort_every": 8, "defer_access": True}),
    ("streamingMK", wavefront_mk.render_tile_streaming_mk,
     jwmk.render_tile_streaming_mk, {"n_lanes": 120}),
]
#: the rows whose bounce runs the march; the others never read the boundary
MARCHING = ("naiveSK", "naiveMK", "regenerationSK 0")


@pytest.mark.parametrize("row", VARIABLE_JAX_ROWS,
                         ids=[r[0] for r in VARIABLE_JAX_ROWS])
def test_variable_row_matches_jax_render_tile(row):
    """16^2 x 2 under --boundary variable against JAX's render_tile:
    n_rays exact, images to 1e-4.  The marching rows run JAX op by op
    (jax.disable_jit()) with the null BSDF: XLA's CPU jit contracts the
    gradient's lerps into fmas, and near the default threshold (1e-8) that
    moves ~10% of the march's stops (JAX jit and op by op part there,
    ROADMAP C), and a gradient normal carries XLA's transcendentals' last
    bits into GGX (a ray in ~900).  streamingSK, sortingSK and streamingMK
    never read the boundary model (streaming.extend_step, in both
    packages): JAX jit, GGX, and their images equal the AABB's."""
    import jax

    label, port, jax_fn, kw = row
    marching = label in MARCHING
    t_args, j_args = variable_args(res=16, spp=2)
    if marching:
        from cudavolumerenderer_tpu.scene import types as jtypes

        flags = dict(boundary="variable", bsdf_kind="null")
        t_args = (*t_args[:2], ttypes.RenderSettings.from_flags(True, **flags),
                  *t_args[3:])
        j_args = (*j_args[:2], jtypes.RenderSettings.from_flags(True, **flags),
                  *j_args[3:])
    a, ra = port(*t_args, **kw)
    if marching:
        with jax.disable_jit():
            b, rb = jax_fn(*j_args, **kw)
    else:
        b, rb = jax_fn(*j_args, **kw)
    assert float(ra) == float(rb) > 16 * 16 * 2, label
    np.testing.assert_allclose(a.numpy(), np.asarray(b), **JAX_TOL,
                               err_msg=label)
    if not marching:
        c, rc = port(*args_pair(res=16, spp=2)[0], **kw)
        assert torch.equal(a, c) and float(ra) == float(rc), label


def test_one_lane_marches_as_in_the_pool():
    """variable_boundary_adjust on one lane alone equals that lane's march
    in the pool (hit, inside, distance, normal and the RNG state bit for
    bit): the loop's iteration count is each running lane's own, which is
    what lets the kernel march one lane per thread."""
    from cudavolumerenderer_tpu_torch.ops import aabb
    from cudavolumerenderer_tpu_torch.ops.rng import RngState, make_rng

    scene = args_pair()[0][0]
    # a threshold the blob's edge stays under, so marches take steps
    settings = ttypes.RenderSettings.from_flags(True, boundary="variable",
                                                boundary_threshold=0.05)
    med = scene.medium
    rs = np.random.RandomState(8)
    n = 96
    o = torch.tensor(np.concatenate([np.full((n, 1), -1.5), rs.uniform(
        -0.4, 0.4, (n, 2))], -1), dtype=torch.float32)
    d = torch.tensor(np.concatenate([np.ones((n, 1)), rs.uniform(
        -0.4, 0.4, (n, 2))], -1), dtype=torch.float32)
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    inside = rs.rand(n) < 0.3  # a third start inside the box
    o[inside] = torch.tensor(rs.uniform(-0.3, 0.3, (int(inside.sum()), 3)),
                             dtype=torch.float32)
    active = torch.tensor(rs.rand(n) < 0.9)
    isect = aabb.aabb_intersect(med.box_min, med.box_max, o, d)
    rng = make_rng(4, torch.arange(n))
    pool, prng = integrator.variable_boundary_adjust(
        scene, settings, o, d, isect, rng, active)
    moved = 0
    for i in range(n):
        k = slice(i, i + 1)
        one, orng = integrator.variable_boundary_adjust(
            scene, settings, o[k], d[k], aabb.Isect(*(x[k] for x in isect)),
            RngState(rng.state[k], rng.inc[k]), active[k])
        for name in aabb.Isect._fields:
            assert torch.equal(getattr(one, name)[0],
                               getattr(pool, name)[i]), (i, name)
        assert int(orng.state[0]) == int(prng.state[i]), i
        moved += int(one.dist[0] != isect.dist[i])
    assert moved > n // 4


# -- each row against JAX --------------------------------------------------------

JAX_ROWS = [
    ("naiveSK", naive.render_tile, jnaive.render_tile, {}),
    ("naiveMK", wavefront_mk.render_tile, jwmk.render_tile, {}),
    ("regenerationSK 0", regeneration.render_tile, jregen.render_tile,
     {"n_lanes": 200, "refill_group": 1}),
    ("regenerationSK 1", regeneration.render_tile, jregen.render_tile,
     {"n_lanes": 203, "refill_group": 8}),
    ("regenerationSK 2", regeneration.render_tile, jregen.render_tile,
     {"n_lanes": 1000, "refill_group": 1024}),
    ("streamingSK", streaming.render_tile, jstream.render_tile,
     {"n_lanes": 200}),
    ("sortingSK", streaming.render_tile, jstream.render_tile,
     {"n_lanes": 200, "sort_every": 8, "defer_access": True}),
    ("streamingMK", wavefront_mk.render_tile_streaming_mk,
     jwmk.render_tile_streaming_mk, {"n_lanes": 120}),
]


@pytest.mark.parametrize("row", JAX_ROWS, ids=[r[0] for r in JAX_ROWS])
def test_row_matches_jax_render_tile(row):
    """16^2 x 4 with pools no multiple of 8 (203 lanes) and under one
    1,024-lane group (1,000): n_rays exact, images to 1e-4."""
    label, port, jax_fn, kw = row
    t_args, j_args = args_pair(res=16, spp=4)
    a, ra = port(*t_args, **kw)
    b, rb = jax_fn(*j_args, **kw)
    assert float(ra) == float(rb) > 16 * 16 * 4, label
    np.testing.assert_allclose(a.numpy(), np.asarray(b), **JAX_TOL,
                               err_msg=label)


# -- the drain's n_rays fold -----------------------------------------------------------

def fold_rays(n_rays: float, hist) -> float:
    """csrc/familybody.cu drain_kernel's fold of n_rays, on the host:
    hist[j] lanes ran j bounces, so bounce e started with the lanes that
    ran more than e; each bounce's count is rounded to float32 and added
    in bounce order."""
    hist = np.asarray(hist, np.int64)
    live = int(hist[1:].sum())
    n = np.float32(n_rays)
    for e in range(int(np.flatnonzero(hist)[-1]) if hist.any() else 0):
        n = np.float32(n + np.float32(live))
        live -= int(hist[e + 1])
    return float(n)


def loop_sums(n0: float, lengths) -> float:
    """The eager loop's n_rays: per bounce, the float32 sum of the lanes
    alive at its start (each bounce's count exact), added in order."""
    n = torch.tensor(n0, dtype=torch.float32)
    lengths = np.asarray(lengths)
    for b in range(int(lengths.max(initial=0))):
        n = n + torch.tensor(float(np.count_nonzero(lengths > b)),
                             dtype=torch.float32)
    return float(n)


@pytest.mark.parametrize("n0, counts", [
    (0.0, {1: 5, 2: 3, 7: 1}),
    (0.0, {}),
    (123.0, {3: 1000, 1000: 1}),
    # past 2^24: n_rays rounds at every add, the counts are odd
    (float(2 ** 24 - 3), {1: 7, 4: 3, 9: 1001}),
    (float(2 ** 25 + 1), {2: 3, 5: 5}),
])
def test_drain_fold_equals_loop_sums(n0, counts):
    """fold_rays (csrc/familybody.cu drain_kernel's fold: a histogram of
    the lanes' bounce counts, the live count of each bounce added in
    float32 in bounce order) equals the loop's sums bit for bit."""
    hist = np.zeros(1002, np.int64)
    lengths = []
    for j, c in counts.items():
        hist[j] = c
        lengths += [j] * c
    assert fold_rays(n0, hist) == loop_sums(n0, lengths)


def test_drain_fold_with_large_counts():
    """Counts past 2^24 in one bounce (a 2^25-lane pool): the fold rounds
    each bounce's count to float32 as torch.sum's exact count is, then
    the add."""
    hist = np.zeros(8, np.int64)
    hist[1], hist[3] = 2 ** 24 + 1, 2 ** 24 + 3
    want = np.float32(0.0)
    for live in (2 ** 25 + 4, 2 ** 24 + 3, 2 ** 24 + 3):
        want = np.float32(want + np.float32(live))
    assert fold_rays(0.0, hist) == float(want)


# -- a dead lane is a fixed point --------------------------------------------------

def pools(settings, n=64):
    """A PathState and a StreamState of n lanes after a few plain
    evaluations (some alive, some dead), on the blob scene."""
    t_args, _ = args_pair(res=8, spp=1)
    scene, camera = t_args[0], t_args[1]
    ctx = fam.make_context(scene, settings, camera, (8, 8), torch.zeros(2),
                           (8, 8), 64, 5, 0)
    p = integrator.PathState(**regeneration.empty_pool(n, 5, "cpu"))
    img = torch.zeros(n, dtype=torch.int64)
    issued = torch.zeros((), dtype=torch.int64)
    acc = torch.zeros((64, 3))
    for _ in range(3):
        p, img, issued = fam.plain_body(ctx, "refill", p, image_id=img,
                                        issued=issued)
        p, _ = fam.plain_body(ctx, "bounce", p, image_id=img, accum=acc)
    s = streaming.initial_stream_state(n, 5, "cpu")
    sissued = torch.zeros((), dtype=torch.int64)
    for _ in range(6):
        s, _, sissued = fam.plain_body(ctx, "refill", s, issued=sissued)
        s, _ = fam.plain_body(ctx, "extend", s, accum=acc)
    return scene, p, s


def lanes_of(pool, names, keep):
    return {n: stages.lane_field(pool, n)[keep] for n in names}


@pytest.mark.parametrize("rr", [True, False], ids=["rr", "no-rr"])
@pytest.mark.parametrize("bsdf", ["ggx", "null"])
def test_dead_lane_is_a_fixed_point(bsdf, rr):
    """bounce_step and extend_step leave a dead lane's every field as it
    is and draw nothing for it, so running a lane past its death (the
    drain) changes nothing; a dead lane of a stream pool is never
    tracking or pending."""
    settings = ttypes.RenderSettings.from_flags(True, bsdf_kind=bsdf,
                                                russian_roulette=rr)
    scene, p, s = pools(settings)
    dead = ~p.alive
    assert dead.any() and p.alive.any()
    after = integrator.bounce_step(scene, settings, p)
    for n, x in lanes_of(p, fam.PATH_FIELDS, dead).items():
        assert torch.equal(x, lanes_of(after, [n], dead)[n]), n
    sdead = ~s.alive
    assert sdead.any() and not (s.tracking | s.pending)[sdead].any()
    acc = torch.zeros((64, 3))
    after, _ = streaming.extend_step(scene, settings, s, acc)
    for n, x in lanes_of(s, fam.LANE_FIELDS, sdead).items():
        assert torch.equal(x, lanes_of(after, [n], sdead)[n]), n


# -- the layout and the parameters ---------------------------------------------------

def test_kernel_layout_equals_the_wrapper():
    """csrc/familybody.cu's FP_*, IP_*, S_*, OP_* and SC_* enums give the
    values ops/familybody.py packs by."""
    c = enum_values(SOURCE.read_text())
    py = {k: v for k, v in vars(fam).items()
          if re.fullmatch(r"(FP|IP|S|N)_[A-Z0-9_]+", k) and isinstance(v, int)
          and k != "N_CTRL"}  # common.cuh's
    lane = {f"S_{n}": k for k, n in enumerate(
        ("O", "D", "TP", "RAD", "ALIVE", "RS", "RINC", "IMG", "TRACK", "T",
         "MAXT", "NRM", "PEND", "PSCAT"))}
    assert [fam.LANE_FIELDS[k] for k in lane.values()] == list(fam.LANE_FIELDS)
    for name, value in py.items():
        assert c[name] == value, name
    for name, k in lane.items():
        assert c[name] == k, name
    assert [c[f"OP_{op.upper()}"] for op in fam.OPS] == [0, 1, 2, 3]
    assert c["N_SCRATCH"] == fam.N_SCRATCH
    assert f"REFILL_THREADS = {fam.REFILL_BLOCK};" in SOURCE.read_text()
    assert (f"VB_MAX_ITERS = {integrator._VB_MAX_ITERS};"
            in SOURCE.read_text())


def test_parameters_are_the_eager_values():
    """The float vector holds the tensors the eager functions read
    (woodcock's inv_sigmat, the box, the grid extents, the camera, the
    float32 reciprocals of the Python divisors), the integer one the
    modes, the queue and the hashed seed."""
    t_args, _ = args_pair(res=8, spp=3)
    scene, camera, settings = t_args[:3]
    ctx = fam.make_context(scene, settings, camera, (8, 6),
                           torch.tensor([3.0, 5.0]), (40, 30), 144, 77,
                           (1 << 32) + 9, group=8)
    f, i, density, albedo = ctx.params()
    med = scene.medium
    inv, _ = woodcock._inv_sigmat(med.scale, med.max_density, "cpu")
    assert f[fam.FP_INV_SIGMAT] == inv.item()
    assert list(f[fam.FP_EXT:fam.FP_EXT + 3]) == (
        med.box_max - med.box_min).tolist()
    nz, ny, nx = med.density.data.shape
    assert list(f[fam.FP_RMD:fam.FP_RMD + 3]) == [nx - 1, ny - 1, nz - 1]
    assert list(f[fam.FP_CAM:fam.FP_CAM + 12]) == camera.inv_view.reshape(
        -1).tolist()
    assert f[fam.FP_INV_TW] == np.float32(1) / np.float32(8)
    assert f[fam.FP_INV_RESY] == np.float32(1) / np.float32(30)
    assert list(f[fam.FP_TILEX:fam.FP_TILEY + 1]) == [3.0, 5.0]
    assert (i[fam.IP_NPATHS], i[fam.IP_TW], i[fam.IP_NPIX]) == (144, 8, 48)
    assert (i[fam.IP_GROUP], i[fam.IP_BASE]) == (8, 9)
    assert i[fam.IP_SEEDH] == (77 * 0x9E3779B9) & 0xFFFFFFFF
    assert i[fam.IP_NCH] == 4 and i[fam.IP_NEAREST] == 0
    assert density.data_ptr() == med.density.data.data_ptr()
    with pytest.raises(ValueError, match="power of two"):
        fam.make_context(scene, settings, group=12).params()


def test_pointer_slots_hold_the_pool():
    """Each per-lane slot points at its field (a PathState's image_id the
    given tensor), the out slots at the input for an in-place launch, the
    scalars and tables at theirs; a StreamState fills every lane slot."""
    settings = ttypes.RenderSettings.from_flags(True)
    scene, p, s = pools(settings, n=40)
    ctx = fam.make_context(scene, settings, args_pair(res=8)[0][1], (8, 8),
                           torch.zeros(2), (8, 8), 64, 5, 0)
    img = torch.arange(40)
    issued = torch.zeros((), dtype=torch.int64)
    acc = torch.zeros((64, 3))
    prep = fam.KERNEL.prepare(ctx, "refill", p, image_id=img, issued=issued)
    ptrs = list(ctypes_array(prep))
    for k, name in enumerate(fam.PATH_FIELDS):
        assert ptrs[k] == ptrs[fam.S_OUT + k] == stages.lane_field(
            p, name).data_ptr(), name
    assert ptrs[fam.LANE_FIELDS.index("image_id")] == img.data_ptr()
    assert ptrs[fam.LANE_FIELDS.index("tracking")] == 0
    assert ptrs[fam.S_ISSUED] == ptrs[fam.S_ISSUED_OUT] == issued.data_ptr()
    assert ptrs[fam.S_STATUS] != 0 and ptrs[fam.S_CTRL] == 0
    count = torch.zeros((), dtype=torch.int64)
    prep = fam.KERNEL.prepare(ctx, "extend", s, accum=acc, count=count,
                              defer=True)
    ptrs = list(ctypes_array(prep))
    for k, name in enumerate(fam.LANE_FIELDS):
        assert ptrs[k] == stages.lane_field(s, name).data_ptr(), name
    assert ptrs[fam.S_ACCUM] == acc.data_ptr()
    assert ptrs[fam.S_COUNT] == count.data_ptr()
    assert ptrs[fam.S_NRAYS] == ptrs[fam.S_NRAYS_OUT] == s.n_rays.data_ptr()
    assert ptrs[fam.S_STATUS] == 0
    iparams = prep.keep[1]
    assert (iparams[fam.IP_OP], iparams[fam.IP_DEFER], iparams[fam.IP_SPLAT],
            iparams[fam.IP_STREAM]) == (2, 1, 1, 1)
    with pytest.raises(ValueError, match="StreamState"):
        fam.KERNEL.prepare(ctx, "extend", p, accum=acc)
    with pytest.raises(ValueError, match="image_id"):
        fam.KERNEL.prepare(ctx, "bounce", p, accum=acc)
    with pytest.raises(ValueError, match="contiguous"):
        fam.KERNEL.prepare(ctx, "bounce",
                           p._replace(o=p.o.t().contiguous().t()))


def test_kernel_builds_every_lookahead_group():
    """csrc/familybody.cu launches bounce_kernel and drain_kernel at each G
    of familybody.GROUPS and no other, its jump table row holds 2 x
    GROUP_MAX draws, and a bounce's prepared launch carries the width
    rule's group (G, M) and the jump table (rng.jump_constants); a refill
    carries no table."""
    src = SOURCE.read_text()
    for kernel in ("bounce_kernel", "drain_kernel"):
        cases = re.findall(rf"case (\d+): {kernel}<(\d+)><<<", src)
        assert all(a == b for a, b in cases), kernel
        assert tuple(int(a) for a, _ in cases) == fam.GROUPS, kernel
    assert f"GROUP_MAX = {fam.GROUP_MAX};" in src
    settings = ttypes.RenderSettings.from_flags(True)
    scene, p, _ = pools(settings, n=40)
    ctx = fam.make_context(scene, settings, args_pair(res=8)[0][1], (8, 8),
                           torch.zeros(2), (8, 8), 64, 5, 0)
    prep = fam.KERNEL.prepare(ctx, "bounce", p)
    iparams, ptrs = prep.keep[1], ctypes_array(prep)
    assert (iparams[fam.IP_LOOK], iparams[fam.IP_LANES]) == fam.lookahead(40)
    table = fam.KERNEL.jump_table(torch.device("cpu"))
    assert ptrs[fam.S_JUMP] == table.data_ptr()
    assert torch.equal(table, rng.jump_constants(2 * fam.GROUP_MAX))
    prep = fam.KERNEL.prepare(ctx, "refill", p,
                              image_id=torch.arange(40),
                              issued=torch.zeros((), dtype=torch.int64))
    assert ctypes_array(prep)[fam.S_JUMP] == 0


def ctypes_array(prep):
    """The pointer array of a prepared launch, null slots as 0."""
    return [x or 0 for x in prep.keep[2]]


# -- the bound ------------------------------------------------------------------------

def test_family_bytes_counts_lanes_and_distinct_voxels():
    """family_bytes: the fields each lane reads and changes at their sizes
    (a dead lane its 1 B alive flag), each distinct voxel once (the albedo
    with its 4 channels), each splatted pixel read and written; a drain's
    evaluations read a field once unless an earlier one wrote it."""
    settings = ttypes.RenderSettings.from_flags(True)
    scene, p, s = pools(settings)
    ctx = fam.make_context(scene, settings)
    dead = ~p.alive
    taps = []
    fam.plain_body(ctx, "bounce", integrator.PathState(
        *[x.clone() if isinstance(x, torch.Tensor) else x for x in p]),
        taps=taps)
    state = [x for k, x in taps if k == "state"]
    assert len(state) == 1
    read, written = {n: state[0][n][0] for n in state[0]}, {
        n: state[0][n][1] for n in state[0]}
    assert bool(read["alive"].all()) and not read["o"][dead].any()
    assert not any(written[n][dead].any() for n in written)
    lanes = sum(fam.FIELD_BYTES[n] * int(read[n].sum() + written[n].sum())
                for n in read)
    vox = int(torch.unique(torch.cat(
        [x for k, x in taps if k == "density"])).numel())
    alb = int(torch.unique(torch.cat(
        [x for k, x in taps if k == "albedo"])).numel())
    assert fam.family_bytes(ctx, taps) == lanes + 4 * vox + 16 * alb
    # an all-dead pool: 1 B a lane
    none = p._replace(alive=torch.zeros_like(p.alive))
    taps = []
    fam.plain_body(ctx, "bounce", none, taps=taps)
    assert fam.family_bytes(ctx, taps) == 64
    # the same field written by one evaluation and read by the next: once
    t1 = {"o": (torch.tensor([True, True]), torch.tensor([True, False]))}
    t2 = {"o": (torch.tensor([True, True]), torch.tensor([False, False]))}
    assert fam.family_bytes(ctx, [("state", t1), ("state", t2)]) == 12 * 3
    assert fam.family_bytes(ctx, [("accum", torch.tensor([3, 3, 5]))]) == 48


def test_refill_bytes_read_only_alive_flags():
    """A refill reads each lane's alive flag and writes the taking lanes'
    fields (a PathState's image_id beside them)."""
    settings = ttypes.RenderSettings.from_flags(True)
    scene, p, _ = pools(settings)
    t_args, _ = args_pair(res=8, spp=1)
    ctx = fam.make_context(scene, settings, t_args[1], (8, 8),
                           torch.zeros(2), (8, 8), 10_000, 5, 0)
    taps = []
    img = torch.zeros(64, dtype=torch.int64)
    new, img2, _ = fam.plain_body(ctx, "refill", p, image_id=img,
                                  issued=torch.tensor(3), taps=taps)
    (_, traffic), = taps
    takes = ~p.alive
    for name, (read, _) in traffic.items():
        assert bool(read.all()) if name == "alive" else not read.any(), name
    assert torch.equal(traffic["rng_inc"][1], takes)
    assert torch.equal(traffic["image_id"][1], takes & (img2 != img))


# -- the routing ------------------------------------------------------------------------

def test_routing_keeps_the_cpu_and_the_options_eager():
    """route: the kernels on the card only, never with eager_body=True, and
    for either boundary model (the bounce kernel runs the variable
    boundary's march); on the CPU the runners launch nothing, and run_body
    raises on a device without a kernel.  The variable boundary's
    parameters reach the kernel's vectors."""
    aabb = ttypes.RenderSettings.from_flags(True)
    var = ttypes.RenderSettings.from_flags(True, boundary="variable",
                                           boundary_threshold=1e-4,
                                           boundary_min_step=0.05)
    assert fam.route("cuda")
    assert not fam.route("cpu")
    assert not fam.route("cuda", eager_body=True)
    t_args, _ = args_pair(res=8, spp=1)
    fam.KERNEL.reset()
    for runner in (naive.render_tile, wavefront_mk.render_tile,
                   regeneration.render_tile, streaming.render_tile,
                   wavefront_mk.render_tile_streaming_mk):
        runner(*t_args)
        runner(*t_args, eager_body=True)
    assert fam.KERNEL.launches == fam.KERNEL.drain_launches == 0
    assert sum(fam.KERNEL.by_op.values()) == 0
    assert fam.KERNEL.plain_evals["bounce"] > 0
    assert fam.KERNEL.plain_evals["extend"] > 0
    settings = ttypes.RenderSettings.from_flags(True)
    scene, p, _ = pools(settings, n=8)
    meta = p._replace(alive=torch.empty(8, dtype=torch.bool, device="meta"))
    with pytest.raises(ValueError, match="no kernel for device meta"):
        fam.run_body(fam.make_context(scene, settings), "bounce", meta)
    f, i, _, _ = fam.make_context(scene, var).params()
    assert i[fam.IP_VARIABLE] == 1
    assert f[fam.FP_MINSTEP] == np.float32(0.05)
    assert f[fam.FP_MSE] == np.float32(0.05 + 1e-5)
    assert f[fam.FP_THRESH] == np.float32(1e-4)
    assert fam.make_context(scene, aabb).params()[1][fam.IP_VARIABLE] == 0
