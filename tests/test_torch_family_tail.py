"""The queue-fed loops' tails (csrc/familybody.cu) on the CPU, which has no
card.

regenerationSK's and streamingSK/sortingSK's loops run in two parts: a
queue stage while paths are unissued (its count the paths not yet issued),
and the tail from the iteration e0 at which every path is issued.  In the
tail a refill takes nothing, so each lane runs alone until it dies: on the
card one drain launch (drain_kernel with the splat for the bounce,
extend_drain_kernel for the extend), or for sortingSK gated chains of the
sort, the flush and one drain segment up to the next sort point.  The
kernels cannot run here, so this file holds:

- a plain model of each tail drain's bookkeeping (`model_*_tail`): every
  lane alive at e0 runs to its death (or, with the deferred fetch, its
  stall) with its own count j of evaluations, a lane that stopped a fixed
  point of the eager body; per-evaluation counts (a bounce's lanes alive
  at its start from the histogram of j, an extend's segment starts) folded
  into n_rays in float32 in the loop's order; the trip count E = e0 + max j,
  for the extend rounded up to check_every; capped launches (the drain's
  DRAIN_CAP) relaunched from e0 + cap; sortingSK's segments capped at its
  sort points.  The model must give the port's eager tail
  (familybody.regenerate_tail / stream_tail on the CPU) bit for bit: lane
  fields, n_rays and evaluations; images to float-summation order;
- a few lanes of each tail run alone (the pool's other lanes dead) against
  the model's lanes;
- the queue stage plus the tail (the CPU render) against JAX's
  render_tile (n_rays exact, images to 1e-4, as tests/test_torch_schedulers
  holds the rows), with a pool four times wider than the image, so that
  tail lanes share pixels.
tests/test_torch_cuda.py holds the kernels' tails against these eager
tails on the card.
"""

import numpy as np
import pytest
import torch

from cudavolumerenderer_tpu.models import regeneration as jregen
from cudavolumerenderer_tpu.models import streaming as jstream
from cudavolumerenderer_tpu_torch.models import integrator, regeneration
from cudavolumerenderer_tpu_torch.models import streaming
from cudavolumerenderer_tpu_torch.ops import familybody as fam
from cudavolumerenderer_tpu_torch.ops.stages import lane_field
from test_torch_schedulers import JAX_TOL, args_pair

torch.set_num_threads(2)

RES, SPP = 8, 8  # 512 paths over 64 pixels
PORT_TOL = dict(rtol=1e-5, atol=1e-5)

# (label, Config-free keywords of render_tile): pools of 256 lanes over 64
# pixels, one of 100 (no multiple of the group of 8), one under a group of
# 1,024 lanes (every lane refills alone), and sorts off the chain boundary
REGEN_ROWS = [
    ("regenerationSK 0", dict(n_lanes=256, refill_group=1)),
    ("regenerationSK 1", dict(n_lanes=100, refill_group=8)),
    ("regenerationSK 2", dict(n_lanes=512, refill_group=1024)),
]
STREAM_ROWS = [
    ("streamingSK", dict(n_lanes=256)),
    ("sortingSK", dict(n_lanes=256, sort_every=8, defer_access=True)),
    ("sorting every 3, no defer", dict(n_lanes=256, sort_every=3,
                                       check_every=4)),
    ("sorting every 3, deferred", dict(n_lanes=200, sort_every=3,
                                       defer_access=True)),
]


# -- pools at e0 -------------------------------------------------------------------

def regen_at_e0(kw):
    """A regenerationSK pool after the port's eager queue stage: (ctx,
    pool, image_id, paths_issued, accum, e0)."""
    (scene, camera, settings, tile_dim, tile_offset, res, spp, seed,
     base) = args_pair(res=RES, spp=SPP)[0]
    n_paths = tile_dim[0] * tile_dim[1] * spp
    width = min(kw["n_lanes"], n_paths)
    ctx = fam.make_context(scene, settings, camera, tile_dim, tile_offset,
                           res, n_paths, seed, base, group=kw["refill_group"])
    s = integrator.PathState(**regeneration.empty_pool(width, seed, "cpu"))
    img = torch.zeros(width, dtype=torch.int64)
    issued = torch.zeros((), dtype=torch.int64)
    accum = torch.zeros((tile_dim[0] * tile_dim[1], 3))
    s, img, issued, e0 = fam.regenerate_queue(ctx, s, img, issued, accum,
                                              False)
    return ctx, s, img, issued, accum, e0


def stream_kw(kw):
    return dict(sort_every=kw.get("sort_every", 0),
                defer=kw.get("defer_access", False),
                check_every=kw.get("check_every", streaming.CHECK_EVERY))


def stream_at_e0(kw):
    """A streaming pool after the port's eager queue stage: (ctx, pool,
    paths_issued, accum, e0)."""
    (scene, camera, settings, tile_dim, tile_offset, res, spp, seed,
     base) = args_pair(res=RES, spp=SPP)[0]
    n_paths = tile_dim[0] * tile_dim[1] * spp
    width = min(kw["n_lanes"], n_paths)
    ctx = fam.make_context(scene, settings, camera, tile_dim, tile_offset,
                           res, n_paths, seed, base)
    s = streaming.initial_stream_state(width, seed, "cpu")
    issued = torch.zeros((), dtype=torch.int64)
    accum = torch.zeros((tile_dim[0] * tile_dim[1], 3))
    s, issued, e0 = fam.stream_queue(ctx, s, issued, accum, kernel=False,
                                     **stream_kw(kw))
    return ctx, s, issued, accum, e0


# -- the models ----------------------------------------------------------------------

def fold(n0, counts):
    """n_rays after evaluations whose counts are `counts`: each count in
    float32, added in order (the drains' last block)."""
    n = n0.clone()
    for c in counts:
        n = n + torch.tensor(float(c), dtype=torch.float32)
    return n


def lanes_equal(a, b, mask, names):
    """Whether the pools' fields `names` are bit-equal on the lanes of
    `mask`."""
    for name in names:
        x, y = lane_field(a, name)[mask], lane_field(b, name)[mask]
        if x.dtype == torch.float32:
            x, y = x.view(torch.int32), y.view(torch.int32)
        if not torch.equal(x, y):
            return False
    return True


def model_regen_tail(ctx, s, img, accum, e0, cap=None):
    """drain_kernel on regenerationSK's pool at e0, with the splat and no
    path bound: each lane alive at e0 bounces until it dies, at most `cap`
    bounces a launch (then relaunched from e0 + cap).  A launch's n_rays:
    hist[j] the lanes that ran j bounces in it, bounce e of the launch
    started with the lanes that ran more than e, each count added in
    float32 in bounce order.  E = max(e0, e0 + the longest lane's
    bounces).  Returns (pool, E, each lane's bounces)."""
    width = s.alive.shape[0]
    total = torch.zeros(width, dtype=torch.int64)
    n_rays, start, lmax = s.n_rays, e0, e0
    going = s.alive.clone()
    while bool(going.any()):
        j = torch.zeros(width, dtype=torch.int64)
        while bool(going.any()) and (cap is None or int(j.max()) < cap):
            before = s
            s, _ = fam.plain_body(ctx, "bounce", s, image_id=img,
                                  accum=accum)
            # a lane that stopped is a fixed point of the bounce
            assert lanes_equal(before, s, ~going, fam.PATH_FIELDS)
            j += going
            going = going & s.alive
        hist = torch.bincount(j, minlength=int(j.max()) + 2)
        live, counts = int((j > 0).sum()), []
        for e in range(int(j.max())):
            counts.append(live)
            live -= int(hist[e + 1])
        n_rays = fold(n_rays, counts)
        finished = (j > 0) & ~going
        if bool(finished.any()):
            lmax = max(lmax, start + int(j[finished].max()))
        total += j
        start += cap if cap is not None else 0
    return s._replace(n_rays=n_rays), lmax, total


def extends(s, defer):
    """The lanes whose next extend can change them (extend_drain_kernel's
    `extends`)."""
    go = s.alive | s.tracking
    return go & ~s.pending if defer else go


def starts_of(s, defer):
    """The lanes whose next extend starts a segment (n_rays)."""
    need = s.alive & ~s.tracking
    return need & ~s.pending if defer else need


def run_extends(ctx, s, accum, defer, cap):
    """Every lane that extends runs until it stops or has run `cap`
    evaluations (None: no cap): (pool, each lane's evaluations, each
    evaluation's segment starts)."""
    width = s.alive.shape[0]
    j = torch.zeros(width, dtype=torch.int64)
    counts = []
    going = extends(s, defer)
    while bool(going.any()) and (cap is None or len(counts) < cap):
        before = s
        starts = starts_of(s, defer) & going
        s, _ = fam.plain_body(ctx, "extend", s, accum=accum, defer=defer)
        assert lanes_equal(before, s, ~going, fam.LANE_FIELDS)
        counts.append(int(starts.sum()))
        j += going
        going = going & extends(s, defer)
    return s, j, counts


def model_stream_tail(ctx, s, accum, e0, sort_every, defer, check_every,
                      cap=None):
    """extend_drain_kernel on a streaming pool at e0 (a multiple of
    check_every).  Without a sort: each lane extends until it dies, at most
    `cap` evaluations a launch (then relaunched from e0 + cap), each
    evaluation's segment starts added to n_rays in float32 in order;
    E = the longest lane's end rounded up to check_every.  With a sort:
    chains of check_every evaluations while a lane is alive at a chain's
    start, each sort point running the Morton sort and (with defer) the
    flush, each run up to the next sort point one segment of at most its
    length per lane (a lane stalled pending stops), E the chains' end.
    Returns (pool, E)."""
    n_rays, med = s.n_rays, ctx.scene.medium
    if sort_every <= 0:
        lmax, start = e0, e0
        while bool(extends(s, defer).any()):
            s, j, counts = run_extends(ctx, s, accum, defer, cap)
            n_rays = fold(n_rays, counts)
            done = (j > 0) & ~extends(s, defer)
            if bool(done.any()):
                lmax = max(lmax, start + int(j[done].max()))
            start += cap if cap is not None else 0
        return s._replace(n_rays=n_rays), -(-lmax // check_every) * check_every
    it = e0
    while bool(s.alive.any()):  # the loop's read at a chain's start
        end = it + check_every
        while it < end:
            if it % sort_every == 0:
                s = streaming._morton_reorder(s, med.box_min, med.box_max)
                if defer:
                    s, _ = fam.plain_body(ctx, "flush", s, accum=accum)
            seg = min(end, (it // sort_every + 1) * sort_every) - it
            s, _, counts = run_extends(ctx, s, accum, defer, seg)
            n_rays = fold(n_rays, counts + [0] * (seg - len(counts)))
            s = s._replace(n_rays=n_rays)
            it += seg
    return s._replace(n_rays=n_rays), it


def pools_equal(a, b, names):
    bad = [n for n in names if not lanes_equal(a, b, slice(None), [n])]
    if a.n_rays.view(torch.int32).item() != b.n_rays.view(torch.int32).item():
        bad.append("n_rays")
    return bad


# -- the models against the eager tails ------------------------------------------------

@pytest.mark.parametrize("cap", [None, 3], ids=["one-launch", "cap-3"])
@pytest.mark.parametrize("row", REGEN_ROWS, ids=[r[0] for r in REGEN_ROWS])
def test_regen_tail_model_equals_eager_tail(row, cap):
    """The drain's model on the pool at e0 equals the eager tail (refills
    that take nothing and bounces while a lane is alive) bit for bit in
    every lane field, n_rays and the loop's evaluations, at one launch and
    capped at 3 bounces a launch; the images to summation order."""
    label, kw = row
    ctx, s, img, issued, accum, e0 = regen_at_e0(kw)
    assert 0 < e0 and bool(s.alive.any()), label
    acc_m, acc_e = accum.clone(), accum.clone()
    got, e_model, j = model_regen_tail(ctx, fam.own(s), img, acc_m, e0, cap)
    want, e_eager = fam.regenerate_tail(ctx, fam.own(s), img, issued.clone(),
                                        acc_e, e0, False)
    assert not pools_equal(got, want, fam.PATH_FIELDS), label
    assert e_model == e_eager == e0 + int(j.max()) > e0, label
    torch.testing.assert_close(acc_m, acc_e, **PORT_TOL)
    if cap is not None:
        assert int(j.max()) > cap  # the drain relaunched


# each row at one launch; streamingSK also capped at 5 evaluations a launch
# (a sorted tail's segments are capped by its sort points)
STREAM_CASES = [(row, None) for row in STREAM_ROWS] + [(STREAM_ROWS[0], 5)]


@pytest.mark.parametrize("row, cap", STREAM_CASES, ids=[
    r[0] + ("" if cap is None else f", cap {cap}") for r, cap in STREAM_CASES])
def test_stream_tail_model_equals_eager_tail(row, cap):
    """The extend drain's model on the pool at e0 equals the eager tail
    (chains of check_every iterations while a lane is alive) bit for bit
    in every lane field, n_rays and the loop's evaluations: the trip count
    rounded up to check_every, each sort point's sort and flush in place,
    capped launches (no sort) relaunched."""
    label, kw = row
    skw = stream_kw(kw)
    ctx, s, issued, accum, e0 = stream_at_e0(kw)
    assert 0 < e0 and e0 % skw["check_every"] == 0 and bool(s.alive.any())
    acc_m, acc_e = accum.clone(), accum.clone()
    got, e_model = model_stream_tail(ctx, fam.own(s), acc_m, e0, cap=cap,
                                     **skw)
    want, e_eager = fam.stream_tail(ctx, fam.own(s), issued.clone(), acc_e,
                                    e0, kernel=False, **skw)
    assert not pools_equal(got, want, fam.LANE_FIELDS), label
    assert e_model == e_eager > e0 and e_model % skw["check_every"] == 0
    torch.testing.assert_close(acc_m, acc_e, **PORT_TOL)


def test_stream_trip_count_rounds_up_to_check_every():
    """streamingSK's tail: the longest lane ends inside a chain, and the
    loop's evaluations run to the chain's end (the host reads the count
    once per check_every iterations)."""
    ctx, s, issued, accum, e0 = stream_at_e0(dict(n_lanes=256))
    _, j, _ = run_extends(ctx, fam.own(s), accum.clone(), False, None)
    end = e0 + int(j.max())
    _, e_eager = fam.stream_tail(ctx, fam.own(s), issued, accum, e0,
                                 kernel=False, sort_every=0, defer=False,
                                 check_every=8)
    assert e_eager == -(-end // 8) * 8 and e_eager - end in range(8)
    _, e4 = fam.stream_tail(ctx, fam.own(s), issued, accum.clone(), e0,
                            kernel=False, sort_every=0, defer=False,
                            check_every=1)
    assert e4 == end


def test_sorted_tail_stalls_lanes_at_sort_points():
    """sortingSK's tail: lanes stall pending inside a segment (so a
    segment's lanes stop before its cap) and resume after the next sort
    point's flush; the model's segments stop there as the loop does."""
    ctx, s, issued, accum, e0 = stream_at_e0(dict(
        n_lanes=256, sort_every=8, defer_access=True))
    s = fam.own(s)
    _, j, _ = run_extends(ctx, s, accum.clone(), True, 8)
    stalled = (j > 0) & (j < 8)
    assert int(stalled.sum()) > 10


@pytest.mark.parametrize("kind", ["regenerationSK", "streamingSK"])
def test_tail_lanes_run_alone(kind):
    """Three lanes of the tail (the longest) each run alone, every other
    lane of the pool dead, end where the model's pool ends them: a lane's
    tail does not depend on its neighbours."""
    if kind == "regenerationSK":
        ctx, s, img, _, accum, e0 = regen_at_e0(REGEN_ROWS[0][1])
        got, _, j = model_regen_tail(ctx, fam.own(s), img, accum.clone(),
                                     e0)
        names = fam.PATH_FIELDS
    else:
        ctx, s, _, accum, e0 = stream_at_e0(STREAM_ROWS[0][1])
        got, j, _ = run_extends(ctx, fam.own(s), accum.clone(), False, None)
        names = fam.LANE_FIELDS
    for i in torch.argsort(j, descending=True)[:3].tolist():
        alone = torch.zeros_like(s.alive)
        alone[i] = bool(s.alive[i])
        p = fam.own(s)._replace(alive=alone)
        if kind == "regenerationSK":
            p, _, _ = model_regen_tail(ctx, p, img, accum.clone(), e0)
        else:
            p = p._replace(tracking=p.tracking & alone)
            p, _, _ = run_extends(ctx, p, accum.clone(), False, None)
        mask = torch.zeros_like(s.alive)
        mask[i] = True
        assert lanes_equal(p, got, mask, names), (kind, i)


def test_tail_lanes_share_pixels():
    """At e0 the 256-lane pool over 64 pixels holds live lanes of the same
    pixel (the splat's atomics add them in any order on the card)."""
    _, s, img, _, _, _ = regen_at_e0(REGEN_ROWS[0][1])
    live = img[s.alive]
    assert live.numel() > torch.unique(live).numel()
    _, s, _, _, _ = stream_at_e0(STREAM_ROWS[0][1])
    live = s.image_id[s.alive]
    assert live.numel() > torch.unique(live).numel()


# -- the split against JAX ------------------------------------------------------------

SPLIT_ROWS = ([("regenerationSK", regeneration.render_tile,
                jregen.render_tile, label, kw) for label, kw in REGEN_ROWS]
              + [("streaming", streaming.render_tile, jstream.render_tile,
                  label, kw) for label, kw in STREAM_ROWS])


@pytest.mark.parametrize("row", SPLIT_ROWS, ids=[r[3] for r in SPLIT_ROWS])
def test_split_matches_jax_render_tile(row):
    """The CPU render (the queue stage, then the tail from e0) at 8^2 x 8
    against JAX's render_tile, whose lax.while_loop runs every iteration
    with a refill: n_rays exact, images to 1e-4.  The tail runs
    evaluations (0 < e0 < E)."""
    _, port, jax_fn, label, kw = row
    t_args, j_args = args_pair(res=RES, spp=SPP)
    fam.KERNEL.reset()
    a, ra = port(*t_args, **kw)
    split = fam.KERNEL.last_split
    assert 0 < split["e0"] < split["E"] == fam.KERNEL.evals, label
    b, rb = jax_fn(*j_args, **{k: v for k, v in kw.items()
                               if k != "check_every"})
    assert float(ra) == float(rb) > RES * RES * SPP, label
    np.testing.assert_allclose(a.numpy(), np.asarray(b), **JAX_TOL,
                               err_msg=label)
