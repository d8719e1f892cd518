"""render_diff's bounce-lockstep replays (csrc/nestedreplay.cu,
ops/nestedreplay.py) on the CPU, which has no card, and the port of
benchmarks/inverse_scale100.py.

On CPU tensors `nestedreplay.run` is the plain version, the eager loop
(models/differentiable.py `_nested_loop`).  Here it is held against JAX's
`_replay` run op by op (`jax.disable_jit()`: XLA's CPU jit contracts
`a * b + c` into fmas, which moves a path; ROADMAP C) on random inputs made
with numpy from a seed, one- and two-level, pass A and pass B, GGX and the
null boundary, Russian roulette on and off, trilinear and nearest
sampling, a constant and a per-voxel albedo: every lane field bit for bit,
the cotangents within COT_RTOL of each entry and COT_ATOL of the largest
(the two packages' scatter-adds may sum an entry's terms in another
order).  Also: the routing (the CPU never reaches the kernel), the
kernel's parameter vectors and layout against the wrapper's, the bound's
byte count on hand-checked cases, and inverse_scale100's observability
split and driver against the JAX package's.  The kernels against the
eager loop, bit for bit, are in tests/test_torch_cuda.py (card tests).
"""

import json
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cudavolumerenderer_tpu.models import differentiable as jd
from cudavolumerenderer_tpu.models import inverse as jinv
from cudavolumerenderer_tpu.scene.types import RenderSettings as JSettings
from cudavolumerenderer_tpu_torch import convert
from cudavolumerenderer_tpu_torch.benchmarks import inverse_scale100
from cudavolumerenderer_tpu_torch.models import differentiable as td
from cudavolumerenderer_tpu_torch.models import inverse as tinv
from cudavolumerenderer_tpu_torch.ops import nestedreplay as nr
from cudavolumerenderer_tpu_torch.ops.rng import RngState
from cudavolumerenderer_tpu_torch.scene.types import RenderSettings
from test_torch_fastbody import enum_values

torch.set_num_threads(2)

SOURCE = Path(nr.__file__).resolve().parents[1] / "csrc" / "nestedreplay.cu"
ROOT = Path(__file__).resolve().parents[1]

#: cotangents against JAX's, per entry and of the largest entry: XLA's
#: scatter-adds may sum an entry's terms in another order, and a direction
#: that carries XLA's sin/cos last bits moves a trilinear weight
COT_RTOL, COT_ATOL = 1e-4, 1e-5
#: the share of lanes whose radiance, throughput and RNG state must be
#: bit-equal to JAX's: XLA's CPU sin, cos and log differ from torch's by an
#: ulp on some inputs (log on ~14% of the flight draws, where torch's is
#: correctly rounded; ROADMAP C1), which moves an HG or GGX direction's or
#: a flight's last bits and with them a later position, weight or draw (3
#: of 128 lanes of the one-level GGX case).  With XLA's sin, cos and log in
#: the port (`xla_transcendentals`) every field of every lane of every
#: case is bit for bit
SAME_SHARE = 0.97

#: (id, two-level, bsdf, Russian roulette, mitsuba_comparable (trilinear
#: sampling and Mitsuba's GGX sampler; else nearest and Heitz's), a
#: constant albedo, grid n, resolution, spp); every case has 8^2 x 2 lanes,
#: so JAX's op-by-op run compiles each of its ops for one lane shape
CASES = [
    ("1l-ggx-trilinear-voxel-rr", False, "ggx", True, True, False, 12, 8, 2),
    ("1l-null-nearest-const", False, "null", False, False, True, 12, 8, 2),
    ("2l-ggx-heitz-const-rr", True, "ggx", True, False, True, 12, 8, 2),
    ("2l-null-trilinear-voxel", True, "null", False, True, False, 12, 8, 2),
]


def grids(n, const_albedo, seed=0):
    """A random n^3 density with an empty corner (the two-level leap) and a
    per-voxel or constant (1-row) albedo."""
    rs = np.random.RandomState(seed)
    density = (rs.rand(n, n, n) * 0.8).astype(np.float32)
    density[: n // 2, : n // 2, : n // 2] = 0.0
    if const_albedo:
        albedo = np.full((1, 1, 1, 4), 0.7, np.float32)
    else:
        albedo = (0.3 + 0.6 * rs.rand(n, n, n, 4)).astype(np.float32)
    return density, albedo


def problem(case):
    """Both packages' scene, settings, tables and lanes, and pass B's
    weights made with numpy from a seed."""
    _, two, bsdf, rr, mitsuba, const, n, res, spp = case
    density, albedo = grids(n, const)
    flags = dict(russian_roulette=rr, max_path_length=6, bsdf_kind=bsdf)
    jspec = jd.SceneSpec(scale=4.0)
    jscene = jspec.build(jnp.asarray(density), jnp.asarray(albedo))
    jcam = jd.CameraSpec(res_x=res, res_y=res, fov_x_deg=0.5).build()
    lanes, _, o0, d0, rng = jd._lane_setup(jcam, (res, res), spp, 11)
    rs = np.random.RandomState(5)
    g = (rs.rand(lanes, 3) - 0.3).astype(np.float32)
    s = (rs.rand(lanes) - 0.3).astype(np.float32)
    jtables = jd._build_brick_tab(jnp.asarray(density)) if two else None
    j = (jscene, JSettings.from_flags(mitsuba, **flags), jtables,
         (o0, d0, rng, jnp.asarray(s), jnp.asarray(g)))
    tscene = convert.scene_spec_from_jax(jspec).build(density, albedo, "cpu")
    ttables = td._build_brick_tab(torch.tensor(density)) if two else None
    start = (torch.tensor(np.asarray(o0)), torch.tensor(np.asarray(d0)),
             RngState(torch.tensor(np.asarray(rng.state).astype(np.int64)),
                      torch.tensor(np.asarray(rng.inc).astype(np.int64))),
             torch.tensor(s), torch.tensor(g))
    t = (tscene, RenderSettings.from_flags(mitsuba, **flags), ttables, start)
    return j, t, density.size, albedo


def port_problem(case):
    """The port's half of `problem` alone, its lanes from the port's own
    camera (no JAX call)."""
    _, two, bsdf, rr, mitsuba, const, n, res, spp = case
    density, albedo = grids(n, const)
    scene = td.SceneSpec(scale=4.0).build(density, albedo, "cpu")
    cam = td.CameraSpec(res_x=res, res_y=res, fov_x_deg=0.5).build("cpu")
    lanes, _, o0, d0, rng = td._lane_setup(cam, (res, res), spp, 11)
    rs = np.random.RandomState(5)
    g = torch.tensor((rs.rand(lanes, 3) - 0.3).astype(np.float32))
    s = torch.tensor((rs.rand(lanes) - 0.3).astype(np.float32))
    tables = td._build_brick_tab(torch.tensor(density)) if two else None
    settings = RenderSettings.from_flags(
        mitsuba, russian_roulette=rr, max_path_length=6, bsdf_kind=bsdf)
    return (scene, settings, tables, (o0, d0, rng, s, g)), density.size, albedo


def jax_replay(j, record, n_vox, albedo):
    scene, settings, tables, (o0, d0, rng, s, g) = j
    nch = albedo.shape[-1]
    dd = jnp.zeros((n_vox,), jnp.float32)
    da = jnp.zeros((albedo.size // nch, nch), jnp.float32)
    with jax.disable_jit():
        out = jd._replay(scene, settings, o0, d0, rng, s, g, record, dd, da,
                         tables, fused=False)
    return ([np.asarray(x) for x in (out.o, out.d, out.throughput,
                                     out.radiance, out.alive)]
            + [np.asarray(out.rng.state).astype(np.int64)],
            np.asarray(out.d_density), np.asarray(out.d_albedo))


def port_replay(t, record, n_vox, albedo, taps=None):
    scene, settings, tables, start = t
    nch = albedo.shape[-1]
    dd = torch.zeros(n_vox)
    da = torch.zeros((albedo.size // nch, nch))
    ctx = td.nested_context(scene, settings, tables, record, dd, da)
    if taps is None:
        out = nr.run(ctx, *start)
    else:
        out = ctx.plain(*start, taps=taps)
    return [x.numpy() for x in out], dd.numpy(), da.numpy(), ctx


FIELDS = ("o", "d", "throughput", "radiance", "alive", "rng state")


def xla_transcendentals(monkeypatch):
    """torch.sin, torch.cos and torch.log computed by jax.numpy's (XLA's
    CPU kernels) on the same float32 values."""
    for name in ("sin", "cos", "log"):
        monkeypatch.setattr(torch, name, lambda x, f=getattr(jnp, name):
                            torch.from_numpy(np.array(f(x.numpy()))))


def parted_lanes(got, want, names=("throughput", "radiance", "rng state")):
    """The lanes on which two replays' fields `names` are not bit-equal."""
    same = [np.all((got[k] == want[k]).reshape(len(got[k]), -1), axis=1)
            for k in names]
    return np.flatnonzero(~np.logical_and.reduce(same))


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_run_on_cpu_matches_jax_replay(case, monkeypatch):
    """Pass A and pass B of nestedreplay.run on CPU tensors against JAX's
    _replay op by op: alive bit for bit; radiance, throughput and the RNG
    state bit for bit on SAME_SHARE of the lanes (the lanes that part are
    counted and printed); with XLA's sin, cos and log in the port, every
    field (o, d, throughput, radiance, alive, the RNG state) bit for bit
    on every lane; o and d within 1e-6; pass B's cotangents within COT_*;
    pass A adds nothing."""
    j, t, n_vox, albedo = problem(case)
    for record in (False, True):
        want, jdd, jda = jax_replay(j, record, n_vox, albedo)
        got, tdd, tda, _ = port_replay(t, record, n_vox, albedo)
        got = dict(zip(FIELDS, got))
        want = {k: y.astype(got[k].dtype) for k, y in zip(FIELDS, want)}
        assert np.array_equal(got["alive"], want["alive"])
        with monkeypatch.context() as m:
            xla_transcendentals(m)
            same = dict(zip(FIELDS, port_replay(t, record, n_vox, albedo)[0]))
        lanes = len(got["alive"])
        parted = parted_lanes(got, want)
        still = parted_lanes(same, want, FIELDS)
        print(f"{case[0]}, pass {'B' if record else 'A'}: {parted.size} of "
              f"{lanes} lanes part from JAX {parted.tolist()}, with XLA's sin, "
              f"cos and log {still.size} {still.tolist()}")
        assert parted.size <= (1 - SAME_SHARE) * lanes
        assert still.size == 0
        for name in ("o", "d", "throughput", "radiance"):
            np.testing.assert_allclose(got[name], want[name], rtol=0,
                                       atol=1e-6, err_msg=name)
        if not record:
            assert not tdd.any() and not tda.any()
            continue
        assert np.abs(tdd).max() > 0 and np.abs(tda).max() > 0
        for x, y in ((tdd, jdd), (tda, jda)):
            np.testing.assert_allclose(
                x, y, rtol=COT_RTOL, atol=COT_ATOL * np.abs(y).max())


def test_route_and_the_cpu_never_reaches_the_kernel(monkeypatch):
    """route('cpu') is False, and render_diff's one-level backward on the
    CPU runs the eager loop (counted), never the kernel library."""
    assert not nr.route("cpu") and not nr.route("cpu", True)
    assert nr.route("cuda") and not nr.route("cuda", eager_body=True)

    def refuse(*a, **k):
        raise AssertionError("the CPU reached the kernel")

    monkeypatch.setattr(nr.KERNEL, "library", refuse)
    density, albedo = grids(8, True)
    d = torch.tensor(density, requires_grad=True)
    passes = nr.KERNEL.plain_passes
    img = td.render_diff(
        d, torch.tensor(albedo), 3, td.SceneSpec(scale=4.0),
        td.CameraSpec(res_x=4, res_y=4, fov_x_deg=0.5),
        RenderSettings.from_flags(True, max_path_length=4), (4, 4), 1)
    img.sum().backward()
    assert nr.KERNEL.plain_passes == passes + 2  # pass A and pass B
    assert d.grad is not None and torch.isfinite(d.grad).all()


def test_run_raises_on_other_devices():
    ctx = td.nested_context(*port_problem(CASES[1])[0][:3], False)
    x = torch.zeros((1, 3), device="meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        nr.run(ctx, x, x, RngState(x[:, 0], x[:, 0]), x[:, 0], x)


def test_kernel_layout_equals_the_wrappers():
    """csrc/nestedreplay.cu's FP_*, IP_*, S_*, OP_*, REC_*, SC_ and ST_
    enums give the values ops/nestedreplay.py packs by."""
    c = enum_values(SOURCE.read_text())
    py = {k: v for k, v in vars(nr).items()
          if re.fullmatch(r"(FP|IP|S|N|OP|REC)_[A-Z0-9_]+", k)
          and isinstance(v, int)}
    shared = sorted(set(c) & set(py))
    assert len(shared) >= 70
    assert {k: c[k] for k in shared} == {k: py[k] for k in shared}
    assert c["N_SCRATCH"] == nr.N_SCRATCH and c["N_STATS"] == nr.N_STATS
    # the two-level geometry's integers in common.cuh TwoLevel's order
    assert [c[k] - c["IP_NX"] for k in ("IP_NX", "IP_NY", "IP_NZ", "IP_NBX",
                                        "IP_NBY", "IP_HIX", "IP_HIY",
                                        "IP_HIZ")] == list(range(8))


@pytest.mark.parametrize("two", [False, True], ids=["one-level", "two-level"])
def test_context_packs_the_eager_loops_values(two):
    """make_context's vectors hold the float32 values the eager loop reads
    at their slots, and the record mode follows torch's
    deterministic-algorithms switch."""
    case = CASES[2] if two else CASES[0]
    scene, settings, tables, _ = port_problem(case)[0]
    ctx = td.nested_context(scene, settings, tables, True,
                            torch.zeros(1), torch.zeros(1, 4))
    med, f, i = scene.medium, ctx.fparams, ctx.iparams
    inv_sigmat = np.float32(1.0) / (np.float32(4.0) * np.float32(1.0))
    assert f[nr.FP_INV_SIGMAT] == inv_sigmat and f[nr.FP_SCALE] == 4.0
    assert f[nr.FP_RHO_MAX] == 1.0
    assert np.array_equal(f[nr.FP_EXT:nr.FP_EXT + 3],
                          (med.box_max - med.box_min).numpy())
    n = case[6]
    assert list(f[nr.FP_RMD:nr.FP_RMD + 3]) == [n - 1] * 3
    assert (i[nr.IP_NX], i[nr.IP_NCH], i[nr.IP_TWO_LEVEL]) == (n, 4, int(two))
    assert i[nr.IP_NEAREST] == int(not case[4])
    assert i[nr.IP_RECORD] == nr.REC_ATOMIC and ctx.record == nr.REC_ATOMIC
    assert i[nr.IP_STEPS] == td.WOODCOCK_CHECK_EVERY == 4
    assert (ctx.major is None) == (not two)
    if two:
        geo = td._geometry(scene, tables)
        assert f[nr.FP_EPSW] == np.float32(geo.epsw)
        assert list(i[nr.IP_HIX:nr.IP_HIZ + 1]) == geo.brick_hi.tolist()
        assert torch.equal(ctx.major, geo.major_flat)
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        assert nr.record_mode(True) == nr.REC_BUFFERS
    finally:
        torch.use_deterministic_algorithms(was)
    with pytest.raises(ValueError, match="1, 3 or 4 channels"):
        td.nested_context(td.SceneSpec().build(
            np.ones((2, 2, 2), np.float32), np.ones((1, 1, 1, 2), np.float32),
            "cpu"), settings, None, False)


def test_nested_bytes_hand_checked():
    """Every lane misses the box: each reads o and d (24 B) and writes its
    radiance and alive flag (13 B), and draws nothing.  Then one lane that
    drew and moved every field, and taps with repeats: the distinct
    entries count once."""
    (scene, settings, tables, start), n_vox, albedo = port_problem(CASES[1])
    o0, d0, rng0, s, g = start
    away = (o0 * 0 + torch.tensor([0.0, 0.0, 100.0]),
            d0 * 0 + torch.tensor([0.0, 1.0, 0.0]))
    taps = []
    out, _, _, ctx = port_replay(
        (scene, settings, tables, (*away, rng0, s, g)), False, n_vox, albedo,
        taps)
    lanes = o0.shape[0]
    end = [torch.tensor(x) for x in out]
    assert not end[4].any() and all(x.numel() == 0 for _, x in taps)
    assert nr.nested_bytes(ctx, taps, *away, rng0, end) == 37 * lanes
    # lane 0 drew and changed o, d, throughput, radiance, alive, its state
    moved = [x.clone() for x in end]
    moved[0][0] += 1.0
    moved[1][0] += 1.0
    moved[2][0] = 0.5
    moved[5][0] = rng0.state[0] + 1
    taps = [("density", torch.tensor([3, 3, 5])), ("albedo", torch.tensor([0])),
            ("brick", torch.tensor([1, 1]))]
    per_draw = 8 + 8  # the RNG's state and increment
    want = 37 * lanes + per_draw + 12 * 3 + 8 + 2 * 4 + 4 * 4 + 8
    assert nr.nested_bytes(ctx, taps, *away, rng0, moved) == want
    # pass B: the weights too, and each cotangent entry read and written
    ctx.iparams[nr.IP_RECORD] = nr.REC_ATOMIC
    taps += [("d_density", torch.tensor([3, 4, 3])),
             ("d_albedo", torch.tensor([0, 0]))]
    assert nr.nested_bytes(ctx, taps, *away, rng0, moved) == (
        want + 16 + 2 * 8 + 4 * 8)


@pytest.mark.parametrize("two", [False, True], ids=["one-level", "two-level"])
def test_eager_loop_reports_its_taps(two):
    """The eager loop's taps are the voxels its samplers read: one-level
    the trilinear sampler's 8 per running lane and step, two-level one tap
    per inside lane and the probed bricks; pass B adds the cotangent
    entries it adds to (a subset of the grids' cells)."""
    case = CASES[2] if two else CASES[0]
    t, n_vox, albedo = port_problem(case)
    taps = []
    out, dd, da, ctx = port_replay(t, True, n_vox, albedo, taps)
    kinds = {k for k, _ in taps}
    assert kinds == ({"density", "albedo", "d_density", "d_albedo", "brick"}
                     if two else {"density", "albedo", "d_density",
                                  "d_albedo"})
    touched = torch.cat([x for k, x in taps if k == "d_density"]).unique()
    assert set(np.flatnonzero(dd).tolist()) <= set(touched.tolist())
    assert int(torch.cat([x for k, x in taps if k == "density"]).max()) < n_vox
    n = nr.nested_bytes(ctx, taps, *t[3][:3], [torch.tensor(x) for x in out])
    assert n > 37 * t[3][0].shape[0]


# -- inverse_scale100 (benchmarks/inverse_scale100.py) --------------------------

def test_observability_split_matches_jax():
    """observability_depth and split_mse_by_observability on the same
    12^3 phantom and a perturbed recovery, both packages."""
    from cudavolumerenderer_tpu.scene import procedural as jproc

    gt = np.asarray(jproc.medical_volume((12, 12, 12), n_blobs=40))
    rec = gt + np.random.RandomState(2).rand(*gt.shape).astype(np.float32) * 0.1
    for scale, tau_c in ((100.0, 5.0), (12.0, 1.0)):
        np.testing.assert_array_equal(tinv.observability_depth(gt, scale),
                                      jinv.observability_depth(gt, scale))
        assert tinv.split_mse_by_observability(rec, gt, 0.25, scale, tau_c) \
            == jinv.split_mse_by_observability(rec, gt, 0.25, scale, tau_c)


def test_inverse_scale100_runs_on_the_cpu(tmp_path):
    """The driver at a tiny size on the CPU: the JAX script's flags and JSON
    keys, the split over both halves, a finite loss."""
    out = tmp_path / "scale100.json"
    res = inverse_scale100.main([
        "--platform", "cpu", "--n", "8", "--res", "4", "--views", "2",
        "--spp", "2", "--target-spp", "1", "--scale", "12", "--steps", "1",
        "0", "0",
        "--out", str(out)])
    text = (ROOT / "benchmarks" / "inverse_scale100.py").read_text()
    jax_keys = set(re.findall(r'^\s+"(\w+)":', text, re.M))
    assert len(jax_keys) >= 10 and jax_keys <= set(res)
    assert json.loads(out.read_text()) == res
    split = res["observability_split"]
    assert set(split) >= {"shell", "interior", "tau_c", "shell_frac"}
    assert np.isfinite(res["loss_last"]) and res["grid"] == "8^3"
