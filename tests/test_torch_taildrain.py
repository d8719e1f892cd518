"""fastSK's tail stage (models/fast.py plain_stage over plain_round, and
its drain ops/taildrain.py + csrc/tailpk.cu's drain_kernel) on the CPU,
which has no card.

On the card the tail stage is one drain launch in which a warp holds one
lane of the pool and runs its rounds to the end; the eager loop is its
plain version.  Here, on the 24^3 medical scene of
tests/test_torch_render.py at pools of 16 and 40 lanes, K = 8:
(a) the restructured plain stage through render_tile(tail_pallas=True)
against the JAX package's render_tile, RR on and off, GGX and the null
boundary, with test_slice_agrees_with_jax_tail_kernel's tolerances, and
the stage itself against JAX's `_run_tailpk_stage` on the same entry
state with n_rays exact (a jitted JAX cascade parts from the port's by a
path or two before the stage: ROADMAP C1); (b) lane independence: each
lane run alone through plain_round to its end equals the round-synchronous
loop bit for bit, and the per-round counts folded in float32 give the
loop's n_rays, n_rows and n_busy, also from an n_rows above 2^24 where the
fold's order matters; (c) the route, and no fallback when the library
fails to build or launch; (d) the drain's parameter vectors hold the
values plain_round uses; and the C layout and the bound's byte count.  The
drain against the eager loop, bit for bit, is in tests/test_torch_cuda.py
(card tests).
"""

import contextlib
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cudavolumerenderer_tpu.models import fast as jfast
from cudavolumerenderer_tpu.ops.rng import RngState as JRng
from cudavolumerenderer_tpu.scene import types as jtypes
from cudavolumerenderer_tpu_torch.models import fast as tfast
from cudavolumerenderer_tpu_torch.ops import fastbody as fb
from cudavolumerenderer_tpu_torch.ops import stages
from cudavolumerenderer_tpu_torch.ops import tailpk as tpk
from cudavolumerenderer_tpu_torch.ops import taildrain as td
from cudavolumerenderer_tpu_torch.ops.rng import M32
from cudavolumerenderer_tpu_torch.scene import types as ttypes
from test_torch_fastbody import enum_values
from test_torch_render import cameras, medical_scenes

torch.set_num_threads(2)

SOURCE = Path(td.__file__).resolve().parents[1] / "csrc" / "tailpk.cu"
RES, SPP, SEED, K = 8, 32, 5, 8


def tail_keywords(R):
    return dict(two_level=True, tail_pallas=True, tail_pk_width=R,
                tail_pk_steps=K, min_width=32)


def settings_of(rr=True, bsdf="ggx", jax=False):
    types = jtypes if jax else ttypes
    return types.RenderSettings.from_flags(
        True, russian_roulette=rr, max_path_length=64, bsdf_kind=bsdf)


def kept_stage(R, rr=True, bsdf="ggx", monkeypatch=None, scenes=None,
               eager=False, res=RES, spp=SPP):
    """The port's with_stats render of the medical scene at res^2 x spp
    with a tail pool of R lanes, keeping its tail stage's (context, a copy
    of the entry state, the result).  With `monkeypatch`, fastbody's gate
    is forced open so render_tile builds the kernel parameters on the CPU
    too."""
    ts, _ = scenes or medical_scenes()
    tc, _ = cameras(res)
    kept, run = [], tfast._run_tailpk_stage

    def keep(state, ctx):
        entry = clone(state)
        out = run(state, ctx)
        kept.append((ctx, entry, out))
        return out

    with contextlib.ExitStack() as stack:
        mp = stack.enter_context(pytest.MonkeyPatch.context())
        mp.setattr(tfast, "_run_tailpk_stage", keep)
        if monkeypatch:
            mp.setattr(fb, "route", lambda *a, **k: True)
        out = tfast.render_tile(
            ts, tc, settings_of(rr, bsdf), (res, res), torch.zeros(2),
            (res, res), spp, SEED, 0, with_stats=True, eager_body=eager,
            **tail_keywords(R))
    assert len(kept) == 1 and kept[0][1].alive.shape[0] == R
    return kept[0], out


def clone(s):
    return type(s)(*(
        type(v)(v.state.clone(), v.inc.clone()) if hasattr(v, "inc")
        else v.clone() for v in s))


def to_jax(s):
    """A port FastState as the JAX package's (int32 counts, uint32 RNG)."""
    f = {}
    for name in s._fields:
        v = getattr(s, name)
        if name == "rng":
            f[name] = JRng(state=jnp.asarray(v.state.numpy().astype(np.uint32)),
                           inc=jnp.asarray(v.inc.numpy().astype(np.uint32)))
        elif v.dtype == torch.int64:
            f[name] = jnp.asarray(v.numpy().astype(np.int32))
        else:
            f[name] = jnp.asarray(v.numpy())
    return jfast.FastState(**f)


def mismatches(a, b, lane=None):
    """The per-lane FastState fields of `a` and `b` (of their lane `lane`
    only, when given) that differ bit for bit."""
    bad = []
    for name in td.LANE_FIELDS:
        x, y = stages.lane_field(a, name), stages.lane_field(b, name)
        if lane is not None:
            x, y = x[lane], y[lane]
        if x.dtype == torch.float32:
            x, y = x.view(torch.int32), y.view(torch.int32)
        if not torch.equal(x, y):
            bad.append(name)
    return bad


# -- (a) the restructured plain stage against JAX ----------------------------

JAX_CASES = [(16, True, "ggx"), (16, False, "ggx"), (40, True, "null"),
             (40, False, "null")]


@pytest.mark.parametrize("R, rr, bsdf", JAX_CASES,
                         ids=[f"R{r}-{'rr' if rr else 'no-rr'}-{b}"
                              for r, rr, b in JAX_CASES])
def test_plain_stage_agrees_with_jax(R, rr, bsdf):
    """The port's render through the restructured plain stage against JAX
    render_tile with the Pallas tail kernel in interpret mode, with
    test_slice_agrees_with_jax_tail_kernel's tolerances; the stage alone
    against JAX's _run_tailpk_stage from the same entry state: n_rays and
    every lane's sample count exact, the accumulators within 1e-4."""
    scenes = medical_scenes()
    ts, js = scenes
    _, jc = cameras(RES)
    (ctx, entry, got), out = kept_stage(R, rr, bsdf, scenes=scenes)
    t_img, t_rays, _, _, t_rows = out
    j_img, j_rays, _, _, j_rows = jfast.render_tile(
        js, jc, settings_of(rr, bsdf, jax=True), (RES, RES),
        jnp.zeros(2, jnp.float32), (RES, RES), SPP, SEED, 0,
        with_stats=True, tail_pk_interpret=True, **tail_keywords(R))
    assert float(t_rows[-1]) > 0 and float(j_rows[-1]) > 0
    t_rays, j_rays = float(t_rays), float(j_rays)
    assert abs(t_rays - j_rays) / j_rays < 0.1
    a, b = t_img.numpy() / SPP, np.asarray(j_img) / SPP
    assert np.isfinite(a).all()
    assert abs(a.mean() - b.mean()) < 0.02, (a.mean(), b.mean())
    assert np.abs(a - b).max() < 0.25
    assert float(np.mean(np.abs(a - b) < 1e-4)) > 0.5

    n_pix = RES * RES

    def path_id_of(pix, slot, samples_done):
        s = slot.astype(jnp.uint32) + samples_done.astype(jnp.uint32)
        return s * jnp.uint32(n_pix) + pix.astype(jnp.uint32)

    want, _ = jfast._run_tailpk_stage(
        to_jax(entry), jnp.zeros((n_pix, 3), jnp.float32), js, jc,
        settings_of(rr, bsdf, jax=True), jnp.zeros(2, jnp.float32),
        (RES, RES), RES, n_pix, 1, SPP, SEED, path_id_of, K, True)
    print(f"R={R} rr={rr} {bsdf}: rays {float(got.n_rays)} / "
          f"{float(want.n_rays)}, rows {float(got.n_rows)} / "
          f"{float(want.n_rows)}, busy {float(got.n_busy)} / "
          f"{float(want.n_busy)}")
    assert float(got.n_rays) == float(want.n_rays)
    np.testing.assert_array_equal(got.samples_done.numpy(),
                                  np.asarray(want.samples_done))
    np.testing.assert_allclose(got.accum.numpy(), np.asarray(want.accum),
                               rtol=0, atol=1e-4)


# -- (b) lane independence ------------------------------------------------------

def finished(s, lanes, spp):
    """`s` with every lane outside `lanes` finished (not pending: the
    round's fixed point)."""
    keep = torch.zeros_like(s.alive)
    keep[lanes] = True
    return s._replace(alive=s.alive & keep, tracking=s.tracking & keep,
                      samples_done=torch.where(keep, s.samples_done, spp))


def loop_rounds(ctx, s):
    """The round-synchronous loop: (the final state, rounds)."""
    exit_box, rounds = torch.zeros_like(s.alive), 0
    while bool((s.alive | (s.samples_done < ctx.spp_per_lane)).any()):
        s, exit_box, _, _ = tfast.plain_round(ctx, s, exit_box)
        rounds += 1
    return s, rounds


@pytest.mark.parametrize("R", [16, 40])
def test_lanes_run_alone_equal_the_loop(R):
    """Each lane of a kept tail pool run alone through plain_round until it
    is no longer pending (the pool's other lanes finished, so the lane keeps
    its place in the tensors: torch's CPU kernels take a vector or a scalar
    path by position) equals the round-synchronous loop bit for bit, and
    the per-round counts of all lanes folded in float32, one round after
    another through the longest lane's rounds, give the loop's n_rays,
    n_rows and n_busy: from the render's counters and from an n_rows of
    2^28 (spacing 32 > R, so the fold's order matters).  At 16^2 x 4 the
    pool's lanes have a sample or two left."""
    (ctx, entry, _), _ = kept_stage(R, res=16, spp=4)
    spp = ctx.spp_per_lane
    big = entry._replace(n_rows=torch.tensor(2.0 ** 28))
    loops = [loop_rounds(ctx, clone(s)) for s in (entry, big)]
    want, rounds = loops[0]
    assert rounds == loops[1][1] > 1
    isect = np.zeros((R, rounds), np.int64)
    busy = np.zeros((R, rounds), np.int64)
    lengths = []
    for lane in range(R):
        s = finished(clone(entry), [lane], spp)
        exit_box, j = torch.zeros_like(s.alive), 0
        while bool(s.alive[lane] | (s.samples_done[lane] < spp)):
            s, exit_box, ni, tr = tfast.plain_round(ctx, s, exit_box)
            assert not (ni | tr)[torch.arange(R) != lane].any()
            isect[lane, j], busy[lane, j] = bool(ni[lane]), bool(tr[lane])
            j += 1
        lengths.append(j)
        assert not mismatches(s, want, lane), lane
    assert max(lengths) == rounds
    for start, (end, _) in zip((entry, big), loops):
        rays, rows, n_busy = (np.float32(float(x)) for x in (
            start.n_rays, start.n_rows, start.n_busy))
        for e in range(rounds):
            rays = np.float32(rays + np.float32(isect[:, e].sum()))
            rows = np.float32(rows + np.float32(R))
            n_busy = np.float32(n_busy + np.float32(busy[:, e].sum()))
        assert (rays, rows, n_busy) == (float(end.n_rays), float(end.n_rows),
                                        float(end.n_busy))
    # at 2^28 each + R rounds to even (R <= 16) or to the next 32 (R = 40):
    # adding R * E at once differs
    bulk = np.float32(np.float32(2.0 ** 28) + np.float32(R * rounds))
    assert bulk != float(loops[1][0].n_rows)


def test_finished_lanes_are_a_fixed_point():
    """A lane that is no longer pending leaves a round unchanged, draws
    nothing and counts in neither n_rays nor n_busy."""
    (ctx, entry, got), _ = kept_stage(16)
    s, exit_box, ni, tr = tfast.plain_round(ctx, clone(got),
                                            torch.zeros_like(got.alive))
    assert not mismatches(s, got)
    assert not (ni | tr | exit_box).any()
    assert float(s.n_rays) == float(got.n_rays)
    assert float(s.n_rows) == float(got.n_rows) + 16


# -- (c) the route, and no fallback ---------------------------------------------

@pytest.mark.parametrize("dev, eager, want", [
    ("cpu", False, False), ("cpu", True, False), ("cuda", False, True),
    ("cuda", True, False), ("meta", False, False)])
def test_route(dev, eager, want):
    assert td.route(dev, eager) is want


def test_cpu_runs_the_plain_stage_and_other_devices_raise():
    """On the CPU the stage runs its eager loop (a host read a round and
    one at the end, no launch), with or without eager_body; run_stage
    raises on a device without a kernel."""
    for eager in (False, True):
        td.KERNEL.reset()
        (ctx, entry, got), _ = kept_stage(16, eager=eager)
        assert td.KERNEL.drain_launches == 0
        assert td.KERNEL.reads == td.KERNEL.plain_rounds + 1 > 1
    assert not mismatches(td.run_stage(ctx, clone(entry)), got)
    meta = entry._replace(alive=torch.empty(16, dtype=torch.bool,
                                            device="meta"))
    with pytest.raises(ValueError, match="no kernel for device meta"):
        td.run_stage(ctx, meta)


def test_failed_build_or_launch_raises(monkeypatch):
    """A library that fails to build raises, and so does a drain whose
    launch fails: nothing falls back to the eager loop."""
    from cudavolumerenderer_tpu_torch.utils import cuda_build

    def no_nvcc(source):
        raise RuntimeError(f"nvcc failed on {source.name}")

    monkeypatch.setattr(cuda_build, "build_library", no_nvcc)
    monkeypatch.setattr(tpk.KERNEL, "_built", None)
    monkeypatch.setattr(td.KERNEL, "_built", None)
    with pytest.raises(RuntimeError, match="nvcc failed on tailpk.cu"):
        td.KERNEL.library()
    assert td.KERNEL._built is None and tpk.KERNEL._built is None

    (ctx, entry, _), _ = kept_stage(16, monkeypatch=True)

    class Lib:
        @staticmethod
        def taildrain_drain(*args):
            return 700  # cudaErrorIllegalAddress

    monkeypatch.setattr(td.KERNEL, "_built", type("B", (), {"lib": Lib}))
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: type("S", (), {"cuda_stream": 0}))
    rounds = td.KERNEL.plain_rounds
    s = clone(entry)
    with pytest.raises(RuntimeError, match="taildrain drain failed: CUDA "
                       "error 700"):
        td.KERNEL.drain(ctx, s)
    assert td.KERNEL.plain_rounds == rounds
    assert not mismatches(s, entry)


# -- (d) the parameter vectors ------------------------------------------------------

def test_parameters_are_the_plain_rounds_values():
    """Unpacked on the host, the drain's vectors hold what plain_round
    reads: the tail kernel's vector, the camera, the tile, the box, Le,
    GGX, the window's epsw (torch.amax(extent) * 1e-6 as brick_window
    computes it), the path-id layout and the brick grid; the path ids and
    brick windows they give equal plain_round's."""
    (ctx, entry, _), _ = kept_stage(40, monkeypatch=True)
    f, i = td.make_params(ctx)
    assert f.dtype == np.float32 and i.dtype == np.int64
    assert f.shape == (td.N_DF,) and i.shape == (td.N_DI,)
    scene, med, camera = ctx.scene, ctx.scene.medium, ctx.camera
    np.testing.assert_array_equal(f[:tpk.N_PARAMS], ctx.params.numpy())
    np.testing.assert_array_equal(
        f[:tpk.N_PARAMS], tfast.tail_params(scene, ctx.settings).numpy())
    assert (f[td.DF_TILEX], f[td.DF_TILEY]) == (0.0, 0.0)
    assert f[td.DF_INV_TW] == np.float32(1) / np.float32(RES)
    assert f[td.DF_INV_RESX] == f[td.DF_INV_RESY] == np.float32(1) / RES
    np.testing.assert_array_equal(f[td.DF_CAM:td.DF_CAM + 12],
                                  camera.inv_view.numpy().reshape(-1))
    np.testing.assert_array_equal(f[td.DF_R2VX:td.DF_R2VY + 1],
                                  camera.raster_to_view.numpy())
    np.testing.assert_array_equal(f[td.DF_BMAX:td.DF_BMAX + 3],
                                  med.box_max.numpy())
    np.testing.assert_array_equal(f[td.DF_LE:td.DF_LE + 3], scene.le.numpy())
    np.testing.assert_array_equal(f[td.DF_ROUGH:td.DF_ROUGH + 2],
                                  scene.bsdf.roughness.numpy())
    assert f[td.DF_ETA] == np.float32(scene.bsdf.eta)
    assert f[td.DF_INV_ETA] == np.float32(1) / np.float32(scene.bsdf.eta)
    assert f[td.DF_EPSW] == np.float32(float(torch.amax(ctx.extent) * 1e-6))
    assert (i[td.DI_SPP], i[td.DI_M], i[td.DI_NPIX], i[td.DI_TW]) == (
        SPP, 1, RES * RES, RES)
    assert i[td.DI_BASE] == 0
    assert i[td.DI_SEEDH] == (SEED * 0x9E3779B9) & 0xFFFFFFFF
    assert (i[td.DI_BSDF], i[td.DI_MITSUBA], i[td.DI_RR]) == (1, 1, 1)
    assert i[td.DI_MAXPATH] == ctx.settings.max_path_length == 64
    nbz, nby, nbx = ctx.tables.dims
    assert (i[td.DI_NBX], i[td.DI_NBY], i[td.DI_NBZ]) == (nbx, nby, nbz)
    assert i[td.DI_STEPS] == K and i[td.DI_CAP] == stages.DRAIN_CAP
    # the path ids the kernel forms from the vector
    s = entry
    sd = s.samples_done + 3
    slot = (s.slot + i[td.DI_M] * sd) & M32
    pid = (slot * i[td.DI_NPIX] + s.pix + i[td.DI_BASE]) & M32
    assert torch.equal(pid, ctx.path_id_of(s.pix, s.slot, sd))
    # the brick windows (numpy float32, op by op as the kernel computes them)
    bflat, worg, inv_sig, rho_b, bexit = tpk.brick_window(
        s.o, s.d, s.t, med.box_min, ctx.extent, ctx.res_minus_1,
        ctx.tables.dims, ctx.tables.major, med.scale)
    o, d, t = s.o.numpy(), s.d.numpy(), s.t.numpy()
    bmin = f[tpk.P_BMINX:tpk.P_BMINX + 3]
    ext = f[tpk.P_EXTX:tpk.P_EXTX + 3]
    rm1 = f[tpk.P_RM1X:tpk.P_RM1X + 3]
    tt = t + f[td.DF_EPSW]
    coord = np.clip((o + tt[:, None] * d - bmin) / ext, np.float32(0),
                    np.float32(1)) * rm1
    hi = np.array([nbx - 1, nby - 1, nbz - 1])
    bi = np.minimum(np.maximum(np.floor(coord / np.float32(16)).astype(
        np.int64), 0), hi)
    flat = (bi[:, 2] * i[td.DI_NBY] + bi[:, 1]) * i[td.DI_NBX] + bi[:, 0]
    np.testing.assert_array_equal(flat, bflat.numpy())
    np.testing.assert_array_equal(bi * 16, worg.numpy())
    rho = ctx.tables.major.numpy()[flat]
    with np.errstate(divide="ignore"):
        inv = np.where(rho > 0, np.float32(1) / (f[tpk.P_SCALE] * np.maximum(
            rho, np.float32(1e-30))), np.float32(np.inf))
    np.testing.assert_array_equal(inv.astype(np.float32), inv_sig.numpy())


# -- the C layout and the bound ----------------------------------------------------

def test_kernel_layout_equals_the_wrappers():
    """csrc/tailpk.cu's DF_*, DI_* and S_* enums give the values
    ops/taildrain.py packs by, its P_* the tail kernel's, and N_PARAMS the
    length of tail_params."""
    c = enum_values(SOURCE.read_text())
    py = {k: v for k, v in vars(td).items()
          if re.fullmatch(r"(DF|DI|S|N)_[A-Z0-9_]+", k) and isinstance(v, int)
          and k != "N_CTRL"}
    assert len(py) >= 40
    for name, value in py.items():
        assert c[name] == value, name
    lane = {f"S_{n}": k for k, n in enumerate(
        ("O", "D", "TP", "ACC", "NRM", "T", "MAXT", "SD", "BOUNCE", "ALIVE",
         "TRACKING", "RS", "RINC"))}
    assert {k: c[k] for k in lane} == lane
    tail = {k: v for k, v in vars(tpk).items()
            if re.fullmatch(r"P_[A-Z0-9]+|N_PARAMS", k)}
    assert {k: c[k] for k in tail} == tail
    for name in ("RUN", "NEED_WINDOW", "EXIT_BOX", "DEAD"):
        assert f"constexpr int {name} = {getattr(tpk, name)};" in SOURCE.read_text()


def test_drain_bytes_counts_lanes_rounds_and_distinct_words():
    yes, no = torch.tensor([True] * 3), torch.tensor([False] * 3)
    state = {"alive": (yes, torch.tensor([False, True, False])),
             "o": (torch.tensor([True, False, False]),) * 2,
             "accum": (no, no)}
    taps = [("state", state), ("round", torch.tensor([True, True, False])),
            ("tab", torch.tensor([3, 3, 9])), ("major", torch.tensor([1, 1])),
            ("state", state), ("round", torch.tensor([False, True, False])),
            ("tab", torch.tensor([9, 12]))]
    # alive read by three lanes, written by one; the second round's reads of
    # what the first wrote do not count again, its writes do not either
    lanes = 3 + 1 + 2 * 12
    want = (lanes + 2 * td.EXIT_BYTES + 2 * td.ROUND_BYTES + td.JUMP_BYTES
            + 3 * 4 + 1 * 4)
    assert td.drain_bytes(taps) == want


def test_plain_round_reports_its_taps():
    """With taps, plain_round runs the tail kernel's plain version and
    reports per round its lane traffic, its lanes and the table and
    majorant words read; the loop with taps equals the loop without."""
    (ctx, entry, got), _ = kept_stage(16)
    taps = []
    s = tfast.plain_stage(ctx, clone(entry), taps)
    assert not mismatches(s, got)
    kinds = [k for k, _ in taps]
    rounds = kinds.count("round")
    assert rounds == kinds.count("state") == kinds.count("major") > 1
    assert kinds.count("tab") == K * rounds
    n = td.drain_bytes(taps)
    assert 16 * 2 < n < 16 * rounds * 400 + 4 * tpk.TROW * 8 + 1e5
