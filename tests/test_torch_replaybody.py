"""render_diff's replay body kernel (csrc/replaybody.cu, ops/replaybody.py)
on the CPU, which has no card, and the port of benchmarks/bench_1024.py.

The fused two-level replay now runs each cascade stage through
ops/replaybody (loop_stage on the CPU, gated chains and the drain on the
card).  Here: the new stage runner against the host loop it replaced (the
parent's loop around the same eager body, transcribed below) bit for bit
in every output and statistic; render_diff (image and both cotangents)
against JAX's render_diff in modes test_torch_diff.py does not cover
(Russian roulette, a constant albedo, the cascade's pools, no cascade),
with that file's tolerances; the kernel's parameter vectors and pointer
slots against the values the eager body reads and the C layout; the
bound's byte count; the routing (the CPU never reaches the kernel,
eager_body reaches the plain body); the properties the drain rests on (a
dead lane is a fixed point of the eager body, and the loop's evaluations
of a last stage are k_chain * ceil(L / k_chain)); and bench_1024's grid,
forward and main() against the JAX script's.  The kernel against the
eager body, bit for bit, is in tests/test_torch_cuda.py (card tests).
"""

import functools
import importlib.util
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cudavolumerenderer_tpu.models import differentiable as jd
from cudavolumerenderer_tpu.models import fast as jfast
from cudavolumerenderer_tpu.ops import camera as jcam
from cudavolumerenderer_tpu.scene import types as jtypes
from cudavolumerenderer_tpu_torch import convert
from cudavolumerenderer_tpu_torch.benchmarks import bench_1024
from cudavolumerenderer_tpu_torch.models import differentiable as td
from cudavolumerenderer_tpu_torch.models import fast as tfast
from cudavolumerenderer_tpu_torch.ops import replaybody as rb
from cudavolumerenderer_tpu_torch.ops.camera import make_camera
from cudavolumerenderer_tpu_torch.ops.rng import RngState
from cudavolumerenderer_tpu_torch.scene import types as ttypes
from test_torch_fastbody import enum_values

torch.set_num_threads(2)

SOURCE = Path(rb.__file__).resolve().parents[1] / "csrc" / "replaybody.cu"
ROOT = Path(__file__).resolve().parents[1]

N, SEED = 16, 7
IMG_TOL = dict(rtol=1e-4, atol=1e-4)


def grids(const_albedo: bool, seed: int = 0):
    """A random 16^3 density with an empty corner (empty bricks: the leap
    path) and a per-voxel or constant (1-row) albedo."""
    rs = np.random.RandomState(seed)
    density = (rs.rand(N, N, N) * 0.8).astype(np.float32)
    density[:8, :8, :8] = 0.0
    if const_albedo:
        albedo = np.full((1, 1, 1, 4), 0.7, np.float32)
    else:
        albedo = (0.3 + 0.6 * rs.rand(N, N, N, 4)).astype(np.float32)
    return density, albedo


def settings_of(bsdf: str, rr: bool):
    return ttypes.RenderSettings.from_flags(
        True, russian_roulette=rr, max_path_length=16, bsdf_kind=bsdf)


# -- (a) the stage runner against the loop it replaced ------------------------

def parent_fused_replay(scene, settings, o0, d0, rng0, s_lane, g_lane,
                        record, dd, da, tables, cascade, min_width,
                        check_every=td.CHECK_EVERY):
    """The fused replay's host loop as it was before the stage runner (the
    alive count read every check_every evaluations), around the same eager
    body: (o, d, throughput, radiance, iterations, rows)."""
    geo = td._geometry(scene, tables)
    body = functools.partial(td._replay_body, scene, settings, geo, record,
                             dd, da)
    n_total = o0.shape[0]
    widths = (tfast._cascade_widths(n_total, 2, min_width) if cascade
              else [n_total])
    outs = [torch.zeros((n_total + 1, 3)) for _ in range(4)]
    zero1 = torch.zeros((n_total,))
    zerob = torch.zeros((n_total,), dtype=torch.bool)
    carry = td._Lanes(
        o=o0, d=d0, tput=torch.ones((n_total, 3)),
        rad=torch.zeros((n_total, 3)),
        alive=torch.ones((n_total,), dtype=torch.bool), rng=rng0,
        bounce=torch.zeros((n_total,), dtype=torch.int64),
        seg=zerob, in_med=zerob, t=zero1, brick_exit=zero1 - 1.0,
        inv_sig=zero1, rho_loc=zero1, max_t=zero1,
        normal=torch.zeros((n_total, 3)),
        lane_id=torch.arange(n_total, dtype=torch.int64),
        s_lane=s_lane, g_lane=g_lane,
    )
    n_iter = rows = 0
    for stage, width in enumerate(widths):
        last = stage == len(widths) - 1
        thresh = 0 if last else widths[stage + 1]
        while int(torch.count_nonzero(carry.alive)) > thresh:
            for _ in range(check_every):
                carry = body(carry)
            n_iter += check_every
            rows += check_every * width
        idx = torch.where(carry.alive, n_total, carry.lane_id)
        for buf, val in zip(outs, (carry.o, carry.d, carry.tput, carry.rad)):
            buf.index_copy_(0, idx, val)
        if not last:
            order = torch.argsort((~carry.alive).to(torch.int32), stable=True)
            carry = tfast._take_lanes(carry, order[: widths[stage + 1]])
    return tuple(b[:n_total] for b in outs) + (n_iter, rows)


def replay_inputs(bsdf, rr, const_albedo, res=16, spp=4, seed=9):
    density, albedo = grids(const_albedo)
    scene = td.SceneSpec(scale=4.0).build(density, albedo, device="cpu")
    cam = td.CameraSpec(res_x=res, res_y=res, fov_x_deg=0.5).build("cpu")
    n, image_id, o0, d0, rng = td._lane_setup(cam, (res, res), spp, seed)
    g_img = torch.tensor(np.random.RandomState(4).rand(res, res, 3)
                         .astype(np.float32))
    return (scene, settings_of(bsdf, rr), td._build_brick_tab(scene.medium
            .density.data), n, image_id, o0, d0, rng, g_img, albedo.shape)


CASES = [(bsdf, rr, const, cascade)
         for bsdf in ("null", "ggx") for rr in (True, False)
         for const in (False, True) for cascade in (True, False)]


@pytest.mark.parametrize(
    "bsdf, rr, const_albedo, cascade", CASES,
    ids=[f"{b}-rr{int(r)}-{'const' if c else 'voxel'}-{'casc' if k else 'one'}"
         for b, r, c, k in CASES])
def test_stage_runner_equals_the_parent_loop(bsdf, rr, const_albedo, cascade):
    """The primal and pass B through _replay_2l_fused (replaybody.loop_stage
    per stage) give the parent loop's o, d, throughput, radiance, both
    cotangents, iterations and rows bit for bit, pools 1,024 / 512 / 256
    with the cascade."""
    (scene, settings, tables, n, image_id, o0, d0, rng, g_img,
     alb_shape) = replay_inputs(bsdf, rr, const_albedo)
    nvox, nrows = N ** 3, int(np.prod(alb_shape[:3]))
    zeros_s, zeros_g = torch.zeros(n), torch.zeros(n, 3)
    stats = {}
    prim = td._replay(scene, settings, o0, d0, rng, zeros_s, zeros_g, False,
                      None, None, tables, cascade=cascade, min_width=256,
                      stats=stats)
    want = parent_fused_replay(scene, settings, o0, d0, rng, zeros_s,
                               zeros_g, False, None, None, tables, cascade,
                               256)
    got = (prim.o, prim.d, prim.throughput, prim.radiance)
    for name, x, y in zip(("o", "d", "throughput", "radiance"), got, want):
        assert torch.equal(x, y), name
    assert (stats["iterations"], stats["rows"]) == want[4:]
    assert stats["iterations"] > 0 and float(prim.radiance.sum()) > 0

    g_lane = g_img.reshape(-1, 3)[image_id] * prim.radiance
    s_lane = torch.sum(g_lane, dim=-1)
    dd, da = torch.zeros(nvox), torch.zeros(nrows, 4)
    stats_b = {}
    out = td._replay(scene, settings, o0, d0, rng, s_lane, g_lane, True, dd,
                     da, tables, cascade=cascade, min_width=256,
                     stats=stats_b)
    dd0, da0 = torch.zeros(nvox), torch.zeros(nrows, 4)
    want_b = parent_fused_replay(scene, settings, o0, d0, rng, s_lane,
                                 g_lane, True, dd0, da0, tables, cascade, 256)
    assert torch.equal(out.d_density, dd0) and torch.equal(out.d_albedo, da0)
    assert torch.equal(out.radiance, want_b[3])
    assert (stats_b["iterations"], stats_b["rows"]) == want_b[4:] == want[4:]
    assert float(dd0.abs().sum()) > 0 and float(da0.abs().sum()) > 0


# -- (b) render_diff against JAX's --------------------------------------------

#: (id, bsdf, constant albedo): Russian roulette on, 8^2 x 4 lanes in
#: pools of 256 / 128 / 64 (both packages' _MIN_WIDTH set to 64).  JAX runs
#: op by op: under jit XLA's CPU compiler contracts a * b + c into fmas,
#: which moves a throughput's last bit and so a roulette decision, and it
#: compiles the three pools' loops for ~100 s
JAX_CASES = [
    ("null-const", "null", True),
    ("ggx-voxel", "ggx", False),
]
JAX_RES = 8


def jax_render_diff(bsdf, const_albedo, res, g_img):
    density, albedo = grids(const_albedo)
    settings = jtypes.RenderSettings.from_flags(
        True, russian_roulette=True, max_path_length=16, bsdf_kind=bsdf)
    spec = jd.SceneSpec(scale=4.0)
    cam = jd.CameraSpec(res_x=res, res_y=res, fov_x_deg=0.5)
    with jax.disable_jit():
        img, vjp = jax.vjp(
            lambda d, a: jd.render_diff(d, a, SEED, spec, cam, settings,
                                        (res, res), 4, True),
            jnp.asarray(density), jnp.asarray(albedo))
        dd, da = vjp(jnp.asarray(g_img))
    return tuple(np.asarray(x) for x in (img, dd, da))


def port_render_diff(bsdf, const_albedo, res, g_img, **kw):
    density, albedo = grids(const_albedo)
    d = torch.tensor(density, requires_grad=True)
    a = torch.tensor(albedo, requires_grad=True)
    img = td.render_diff(
        d, a, SEED, convert.scene_spec_from_jax(jd.SceneSpec(scale=4.0)),
        td.CameraSpec(res_x=res, res_y=res, fov_x_deg=0.5),
        settings_of(bsdf, True), (res, res), 4, True, **kw)
    img.backward(torch.tensor(g_img))
    return img.detach().numpy(), d.grad.numpy(), a.grad.numpy()


def grad_share(got, want):
    """Share of entries within rtol 1e-3, atol 1e-4 x max|want|
    (tests/test_torch_diff.py's)."""
    ok = np.isclose(got, want, rtol=1e-3, atol=1e-4 * np.abs(want).max())
    return float(ok.mean())


@pytest.mark.parametrize("case", JAX_CASES, ids=[c[0] for c in JAX_CASES])
def test_render_diff_matches_jax(monkeypatch, case):
    """Image and both cotangents against JAX's render_diff (Russian
    roulette on, the cascade's three pools), with
    tests/test_torch_diff.py's tolerances: on the null BSDF the same paths
    (image to 1e-4, every voxel within tolerance); under GGX at least 90% of
    pixels, 99% of voxels and the image mean to 1e-3 (XLA's last bits
    differ from torch's near grazing angles); the cotangents' sums to 1e-3
    of their absolute sums."""
    _, bsdf, const = case
    res = JAX_RES
    monkeypatch.setattr(jfast, "_MIN_WIDTH", 64)
    monkeypatch.setattr(tfast, "_MIN_WIDTH", 64)
    g_img = np.random.RandomState(4).rand(res, res, 3).astype(np.float32)
    stats = {}
    ti, tdd, tda = port_render_diff(bsdf, const, res, g_img, stats=stats)
    ji, jdd, jda = jax_render_diff(bsdf, const, res, g_img)
    assert ti.shape == (res, res, 3) and np.isfinite(ti).all()
    assert np.isfinite(tdd).all() and np.isfinite(tda).all()
    assert stats["primal_iters"] == stats["pass_b_iters"]
    pixels = float(np.all(np.isclose(ti, ji, **IMG_TOL), axis=-1).mean())
    shares = {"density": grad_share(tdd, jdd), "albedo": grad_share(tda, jda)}
    print(f"{case[0]}: pixels within 1e-4 {pixels:.4f}; voxels within "
          "tolerance " + ", ".join(f"{k} {v:.4f}" for k, v in shares.items()))
    for got, want in ((tdd, jdd), (tda, jda)):
        assert abs(got.sum() - want.sum()) <= 1e-3 * np.abs(want).sum()
    if bsdf == "null":
        np.testing.assert_allclose(ti, ji, **IMG_TOL)
        assert shares == {"density": 1.0, "albedo": 1.0}
    else:
        assert pixels >= 0.9
        assert min(shares.values()) >= 0.99
        assert abs(ti.mean() - ji.mean()) <= 1e-3 * ji.mean()


# -- (c) the context, the layout and the bound --------------------------------

def test_kernel_layout_equals_the_wrappers():
    """csrc/replaybody.cu's FP_*, IP_*, S_* and REC_* enums and
    csrc/common.cuh's C_* give the values ops/replaybody.py packs by, and
    its lane slots follow LANE_FIELDS."""
    c = enum_values(SOURCE.read_text()
                    + (SOURCE.parent / "common.cuh").read_text())
    py = {k: v for k, v in vars(rb).items()
          if re.fullmatch(r"(FP|IP|S|N|C|REC)_[A-Z0-9_]+", k)
          and isinstance(v, int)}
    lane = {f"S_{n}": k for k, n in enumerate(
        ("O", "D", "TP", "RAD", "NRM", "T", "BEXIT", "ISL", "RLOC", "MAXT",
         "BOUNCE", "RS", "ALIVE", "SEG", "INMED"))}
    assert {k: c[k] for k in lane} == lane
    assert c["N_LANE"] == rb.N_LANE == len(rb.LANE_FIELDS)
    shared = sorted(set(c) & set(py))
    assert len(shared) >= 55
    assert {k: c[k] for k in shared} == {k: py[k] for k in shared}


def context_and_pool(record, const_albedo=False):
    (scene, settings, tables, n, image_id, o0, d0, rng, g_img,
     alb_shape) = replay_inputs("ggx", True, const_albedo, res=8, spp=1)
    geo = td._geometry(scene, tables)
    dd = torch.zeros(N ** 3) if record else None
    da = torch.zeros(geo.albedo_flat.shape) if record else None
    ctx = rb.make_context(scene, settings, geo, record, dd, da, None)
    zeros = functools.partial(torch.zeros, n)
    pool = td._Lanes(
        o=o0.clone(), d=d0.clone(), tput=torch.ones(n, 3), rad=zeros(3),
        alive=torch.ones(n, dtype=torch.bool),
        rng=RngState(rng.state.clone(), rng.inc.clone()),
        bounce=zeros(dtype=torch.int64), seg=zeros(dtype=torch.bool),
        in_med=zeros(dtype=torch.bool), t=zeros(), brick_exit=zeros() - 1,
        inv_sig=zeros(), rho_loc=zeros(), max_t=zeros(), normal=zeros(3),
        lane_id=torch.arange(n), s_lane=zeros(), g_lane=zeros(3))
    return scene, settings, geo, ctx, pool


@pytest.mark.parametrize("record", [False, True], ids=["primal", "pass-b"])
def test_context_packs_the_eager_bodys_values(record):
    """make_context's vectors hold the float32 values the eager body reads
    (the scene's, the geometry's, the settings') at their slots, and the
    record mode follows torch's deterministic-algorithms switch."""
    scene, settings, geo, ctx, _ = context_and_pool(record)
    med, f, i = scene.medium, ctx.fparams, ctx.iparams

    def at(slot, x, k=3):
        return np.array_equal(f[slot:slot + k], np.asarray(
            x.detach(), np.float32).reshape(-1)[:k])

    assert at(rb.FP_BMIN, med.box_min) and at(rb.FP_BMAX, med.box_max)
    assert at(rb.FP_EXT, geo.extent) and at(rb.FP_RM1, geo.res_minus_1)
    assert at(rb.FP_BSIZE, geo.brick_size) and at(rb.FP_LE, scene.le)
    assert at(rb.FP_SCALE, med.scale, 1) and at(rb.FP_G, med.g, 1)
    assert at(rb.FP_EPSW, geo.epsw, 1)
    assert at(rb.FP_ROUGH, scene.bsdf.roughness, 2)
    assert at(rb.FP_ETA, scene.bsdf.eta, 1)
    assert f[rb.FP_INV_ETA] == np.float32(1.0) / f[rb.FP_ETA]
    assert tuple(i[[rb.IP_NX, rb.IP_NY, rb.IP_NZ, rb.IP_NBX, rb.IP_NBY]]) == (
        geo.nx, geo.ny, geo.nz, geo.nbx, geo.nby)
    assert list(i[rb.IP_HIX:rb.IP_HIZ + 1]) == geo.brick_hi.tolist()
    assert (i[rb.IP_BSDF], i[rb.IP_MITSUBA], i[rb.IP_RR]) == (1, 1, 1)
    assert i[rb.IP_MAXPATH] == settings.max_path_length
    assert (i[rb.IP_CONST_ALB], i[rb.IP_NCHAN]) == (0, 4)
    assert i[rb.IP_RECORD] == (rb.REC_ATOMIC if record else rb.REC_NONE)
    assert ctx.major is geo.major_flat and ctx.leap is geo.leap_flat
    assert ctx.density is geo.density_flat and ctx.albedo is geo.albedo_flat
    assert (ctx.d_density is None) == (not record)
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        assert rb.record_mode(True) == rb.REC_BUFFERS
        assert rb.record_mode(False) == rb.REC_NONE
    finally:
        torch.use_deterministic_algorithms(was)


def test_pointer_slots_round_trip():
    """The launch's pointer array holds each lane field, read-only field,
    output field, table, cotangent and control word at its slot, and the
    checks refuse a wrong dtype, shape or a partly overlapping output."""
    _, _, geo, ctx, pool = context_and_pool(True)
    count = torch.zeros((), dtype=torch.int64)
    ctrl = torch.zeros(rb.N_CTRL, dtype=torch.int64)
    out = td._Lanes(*(RngState(v.state.clone(), v.inc) if isinstance(
        v, RngState) else v.clone() for v in pool))
    ptrs = list(rb.ReplayBodyKernel()._pointers(ctx, pool, out, count, ctrl))
    assert len(ptrs) == rb.N_S
    for k, name in enumerate(rb.LANE_FIELDS):
        assert ptrs[k] == rb.lane_field(pool, name).data_ptr(), name
        assert ptrs[rb.S_OUT + k] == rb.lane_field(out, name).data_ptr(), name
    for k, name in enumerate(rb.READ_FIELDS):
        assert ptrs[rb.S_RINC + k] == rb.lane_field(pool, name).data_ptr()
    for slot, x in ((rb.S_MAJOR, geo.major_flat), (rb.S_LEAP, geo.leap_flat),
                    (rb.S_DENSITY, geo.density_flat),
                    (rb.S_ALBEDO, geo.albedo_flat), (rb.S_DD, ctx.d_density),
                    (rb.S_DA, ctx.d_albedo), (rb.S_COUNT, count),
                    (rb.S_CTRL, ctrl)):
        assert ptrs[slot] == x.data_ptr()
    assert ptrs[rb.S_REC_DIDX] is None  # no record buffers outside buffer mode
    with pytest.raises(ValueError, match="t must be"):
        rb.ReplayBodyKernel()._pointers(ctx, pool._replace(t=pool.t.double()),
                                        pool, count)
    with pytest.raises(ValueError, match="g_lane must be"):
        rb.ReplayBodyKernel()._pointers(
            ctx, pool._replace(g_lane=torch.zeros(3, 3)), pool, count)
    half = torch.zeros(pool.t.shape[0] + 1)
    with pytest.raises(ValueError, match="overlaps"):
        rb.ReplayBodyKernel()._pointers(
            ctx, pool._replace(t=half[:-1]), pool._replace(t=half[1:]), count)


def test_replay_bytes_counts_state_and_distinct_taps():
    """replay_bytes: each lane's read and written fields at their sizes,
    the distinct taps once, pass B's touched cotangents read and written;
    over several evaluations (a drain) a field is read once unless an
    earlier evaluation wrote it, and written once.  A pool of dead lanes
    moves its alive flags alone."""
    scene, settings, geo, ctx, pool = context_and_pool(False)
    no = torch.zeros(4, dtype=torch.bool)

    def state(**fields):
        out = dict.fromkeys(rb.FIELD_BYTES, (no, no))
        for name, (r, w) in fields.items():
            out[name] = (torch.tensor(r), torch.tensor(w))
        return out

    T, F = True, False
    e1 = state(alive=([T] * 4, [F, F, F, T]), t=([T, T, F, F], [T, F, F, F]),
               o=([T, T, F, F], [F] * 4))
    taps = [("tap", torch.tensor([3, 3, 9])), ("brick", torch.tensor([1, 1])),
            ("albedo", torch.tensor([5, 5])), ("state", e1),
            ("tap", torch.tensor([9, 12]))]
    tables = 3 * 4 + 8 + 4 * 4
    lanes = (4 + 1) * 1 + (2 + 1) * 4 + 2 * 12
    assert rb.replay_bytes(ctx, taps) == lanes + tables
    _, _, _, ctx_b, _ = context_and_pool(True)
    assert rb.replay_bytes(ctx_b, taps) == lanes + tables + 3 * 8 + 4 * 8
    # lane 0's t was written by the first evaluation: not read again
    e2 = state(alive=([T] * 4, [F] * 4), t=([T, T, T, F], [F, T, F, F]))
    assert rb.replay_bytes(ctx, [("state", e1), ("state", e2)]) == (
        (4 + 1) * 1 + (3 + 2) * 4 + 2 * 12)
    assert rb.replay_bytes(ctx, []) == 0
    plain = functools.partial(td._replay_body, scene, settings, geo, False,
                              None, None)
    taps = []
    plain(pool._replace(alive=torch.zeros_like(pool.alive)), taps=taps)
    assert rb.replay_bytes(ctx, taps) == pool.alive.shape[0]


def test_eager_body_reports_its_taps():
    """The eager body's taps are the inside lanes' density indices, the
    probing lanes' brick rows, the scattering lanes' albedo rows and each
    field's readers and writers (a written field is a changed one), and
    giving it a list changes nothing it computes."""
    scene, settings, geo, _, pool = context_and_pool(False)
    plain = functools.partial(td._replay_body, scene, settings, geo, False,
                              None, None)
    s, n_taps = pool, 0
    for _ in range(6):
        taps = []
        got = plain(s, taps=taps)
        want = plain(s)
        assert all(torch.equal(x.state, y.state) if isinstance(x, RngState)
                   else torch.equal(x, y) for x, y in zip(got, want))
        assert [k for k, _ in taps] == ["tap", "brick", "albedo", "state"]
        n_taps += taps[0][1].numel()
        traffic = taps[3][1]
        assert set(traffic) == set(rb.FIELD_BYTES)
        for name, (read, written) in traffic.items():
            # a dead lane reads its alive flag alone and writes nothing
            assert bool(read[~s.alive].all() if name == "alive"
                        else not read[~s.alive].any()), name
            assert not bool(written[~s.alive].any()), name
            if name not in ("rng_state", "rng_inc"):
                # changed bit for bit (NaN to NaN unchanged, 0.0 to -0.0 not)
                before, after = (
                    x.view(torch.int32) if x.is_floating_point() else x
                    for x in (rb.lane_field(s, name),
                              rb.lane_field(got, name)))
                same = before == after
                assert torch.equal(written, ~(
                    same.all(dim=-1) if same.ndim == 2 else same)), name
        s = got
    assert n_taps > 0


# -- (d) routing and the drain's premises -------------------------------------

def test_render_diff_on_the_cpu_never_reaches_the_kernel(monkeypatch):
    """On the CPU every stage runs the eager body (plain evaluations
    counted, no launch, nothing built); eager_body=True reaches
    replaybody.route, which keeps the kernel out."""
    routes = []
    route = rb.route
    monkeypatch.setattr(rb, "route", lambda dev, eager=False: (
        routes.append((dev, eager)), route(dev, eager))[1])
    density, albedo = grids(False)
    before = (rb.KERNEL.launches, rb.KERNEL.drain_launches,
              rb.KERNEL.plain_evals)
    for eager in (False, True):
        d = torch.tensor(density, requires_grad=True)
        img = td.render_diff(d, torch.tensor(albedo), SEED,
                             td.SceneSpec(scale=4.0),
                             td.CameraSpec(res_x=8, res_y=8, fov_x_deg=0.5),
                             settings_of("null", False), (8, 8), 2, True,
                             eager_body=eager)
        img.sum().backward()
    assert routes == [("cpu", False)] * 2 + [("cpu", True)] * 2
    assert (rb.KERNEL.launches, rb.KERNEL.drain_launches) == before[:2]
    assert rb.KERNEL.plain_evals > before[2]
    assert rb.KERNEL._built is None
    assert not rb.route("cuda", True) and rb.route("cuda") and not rb.route(
        "cpu")


def test_run_body_raises_on_other_devices():
    _, _, _, ctx, pool = context_and_pool(False)
    meta = pool._replace(alive=torch.ones(pool.alive.shape[0],
                                          dtype=torch.bool, device="meta"))
    with pytest.raises(ValueError, match="no kernel for device meta"):
        rb.run_body(ctx, meta)


def kept_stages(monkeypatch, bsdf, rr, const_albedo, record):
    """Each stage's (ctx, entry pool, thresh, k_chain) of one replay run
    through replaybody.run_stage on the CPU."""
    (scene, settings, tables, n, image_id, o0, d0, rng, g_img,
     alb_shape) = replay_inputs(bsdf, rr, const_albedo)
    kept, run = [], rb.loop_stage

    def keep(ctx, s, thresh, k_chain, body=rb.run_body):
        kept.append((ctx, td._Lanes(*(RngState(v.state.clone(), v.inc)
                                       if isinstance(v, RngState)
                                       else v.clone() for v in s)),
                     thresh, k_chain))
        return run(ctx, s, thresh, k_chain, body)

    monkeypatch.setattr(rb, "loop_stage", keep)
    s_lane = torch.rand(n, generator=torch.Generator().manual_seed(1))
    g_lane = torch.rand(n, 3, generator=torch.Generator().manual_seed(2))
    dd = torch.zeros(N ** 3)
    da = torch.zeros(int(np.prod(alb_shape[:3])), 4)
    td._replay(scene, settings, o0, d0, rng, s_lane, g_lane, record, dd, da,
               tables, min_width=256)
    monkeypatch.setattr(rb, "loop_stage", run)
    return kept


@pytest.mark.parametrize("bsdf, rr, record", [
    ("ggx", True, True), ("null", False, False), ("ggx", False, True)])
def test_dead_lane_is_a_fixed_point_of_the_eager_body(monkeypatch, bsdf, rr,
                                                      record):
    """A lane that is not alive keeps every field through an evaluation and
    adds nothing to either cotangent, so the drain may stop each lane at
    its own end."""
    kept = kept_stages(monkeypatch, bsdf, rr, False, record)
    ctx, s, _, k_chain = kept[1]
    for _ in range(3 * k_chain):
        dead = ~s.alive
        before_dd = None if ctx.d_density is None else ctx.d_density.clone()
        before_da = None if ctx.d_albedo is None else ctx.d_albedo.clone()
        ctx.plain(s._replace(alive=torch.zeros_like(s.alive)))
        if record:  # a pool of dead lanes adds exactly nothing
            assert torch.equal(ctx.d_density, before_dd)
            assert torch.equal(ctx.d_albedo, before_da)
        nxt = ctx.plain(s)
        for name in rb.LANE_FIELDS:
            x, y = rb.lane_field(s, name), rb.lane_field(nxt, name)
            assert torch.equal(x[dead], y[dead]), name
        s = nxt
    assert bool(dead.any())


@pytest.mark.parametrize("bsdf, rr, const_albedo", [
    ("ggx", True, False), ("null", True, True), ("null", False, False)])
def test_drain_evaluations_equal_the_loops(monkeypatch, bsdf, rr,
                                           const_albedo):
    """On the last stage's entry pool, each lane's evaluations until it
    dies (L: the longest) give E = k_chain * ceil(L / k_chain), the loop's
    evaluations of the stage."""
    kept = kept_stages(monkeypatch, bsdf, rr, const_albedo, False)
    ctx, s0, thresh, k_chain = kept[-1]
    assert thresh == 0
    _, n = rb.loop_stage(ctx, s0, 0, k_chain, rb.plain_body)
    s, ends, j = s0, torch.zeros(s0.alive.shape[0], dtype=torch.int64), 0
    while bool(s.alive.any()):
        s = ctx.plain(s)
        j += 1
        ends = torch.where(s.alive, j, ends)
    longest = int(ends.max()) + 1 if bool(s0.alive.any()) else 0
    assert n == k_chain * -(-longest // k_chain) > 0


# -- (e) bench_1024 -----------------------------------------------------------

def jax_bench():
    """The root benchmarks/bench_1024.py as a module (its main is not run)."""
    spec = importlib.util.spec_from_file_location(
        "jax_bench_1024", ROOT / "benchmarks" / "bench_1024.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("n", [32, 64])
def test_density_1024_matches_the_jax_generator(n):
    """The plume and its hash noise equal the JAX script's grid to 1e-6
    (exp's last bits differ), its occupancy to 1e-4."""
    want = np.asarray(jax_bench().make_density_1024(n))
    got = bench_1024.make_density_1024(n, "cpu").numpy()
    assert got.shape == want.shape == (n, n, n) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert abs((got > 0).mean() - (want > 0).mean()) <= 1e-4
    assert 0.02 < (got > 0).mean() < 0.3


def test_bench_1024_forward_rays_match_jax():
    """The forward block's render (seed 1, 32^2 x 1, two-level, the script's
    scene) traces JAX's fast.render_tile's n_rays on the same grid (JAX op
    by op, with the tail chain of 1 that gives the same rays)."""
    n, res = 32, 32
    density = bench_1024.make_density_1024(n, "cpu")
    dmax = float(density.max())
    scene = ttypes.make_scene(ttypes.make_medium(
        density, (0.9, 0.9, 0.9), scale=100.0, max_density=dmax,
        device="cpu"))
    settings = ttypes.RenderSettings.from_flags(True)
    _, n_rays, *_ = tfast.render_tile(
        scene, make_camera(res, res, device="cpu"), settings, (res, res),
        torch.zeros(2), (res, res), 1, 1, 0, two_level=True, with_stats=True,
        tail_chain=1)
    jscene = jtypes.make_scene(jtypes.make_medium(
        jnp.asarray(density.numpy()), (0.9, 0.9, 0.9), scale=100.0,
        max_density=dmax))
    with jax.disable_jit():  # XLA's CPU jit contracts fmas: a path moves
        jout = jfast.render_tile(
            scene=jscene, camera=jcam.make_camera(res, res),
            settings=jtypes.RenderSettings.from_flags(True),
            tile_dim=(res, res), tile_offset=jnp.zeros(2, jnp.float32),
            full_resolution=(res, res), spp=1, seed=1, path_id_base=0,
            two_level=True, with_stats=True, tail_chain=1)
    assert float(n_rays) == float(jout[1]) > 0


def test_bench_1024_main_runs_on_the_cpu():
    """main(argv) with --bwd at a tiny size runs every block and returns
    finite numbers, the pass-B replay as long as the primal."""
    r = bench_1024.main(["--platform", "cpu", "--n", "32", "--res", "32",
                         "--iters", "1", "--bwd", "--bwd-res", "8"])
    assert r["device"] == "cpu" and r["max_memory_allocated"] is None
    assert 0 < r["occupancy"] < 1 and r["n_rays"] > 0
    assert len(r["fwd_s"]) == 2 and all(np.isfinite(r["fwd_mrays"]))
    assert r["n_paths"] == 64 and r["n_rays_bwd"] > 0 and r["primal_s"] > 0
    assert len(r["fwdbwd"]) == 2
    for rep in r["fwdbwd"]:
        assert np.isfinite([rep["s"], rep["loss"], rep["gsum"]]).all()
        assert rep["primal_iters"] == rep["pass_b_iters"] > 0
    args = bench_1024.parse_args([])
    assert (args.n, args.res, args.iters, args.bwd_spp, args.table_bits,
            args.cascade_factor, args.platform) == (1024, 1024, 4, 1, 32, 2,
                                                    "cuda")
