"""fastSK's body kernel (csrc/fastbody.cu, ops/fastbody.py) on the CPU,
which has no card: the gate that sends a stage to the kernel or to the
eager body (the speculative steps and the deferred GGX flush included, a
spec_k beyond the kernel's limit raising), the flush schedule the kernel
mirrors, the kernel's parameter vectors against the values render_tile
computes, the C layout against the Python one, the stage path under
tail_spec and defer_ggx against the eager loop, and the eager body (the
kernel's plain version) against JAX's render_tile for the modes the
kernel covers that no other test holds: the 'full' and 'split' albedo
tables, two lanes per pixel, one-level GGX and Russian roulette off.  The
kernel against the eager body, bit for bit, is in tests/test_torch_cuda.py
(card tests)."""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cudavolumerenderer_tpu.models import fast as jfast
from cudavolumerenderer_tpu.ops import camera as jcam
from cudavolumerenderer_tpu.scene import procedural
from cudavolumerenderer_tpu.scene import types as jtypes
from cudavolumerenderer_tpu.utils import occupancy as jocc
from cudavolumerenderer_tpu_torch import cli, convert
from cudavolumerenderer_tpu_torch.benchmarks import baseline_configs as bc
from cudavolumerenderer_tpu_torch.config import Config, Kernel
from cudavolumerenderer_tpu_torch.models import fast as tfast
from cudavolumerenderer_tpu_torch.models.renderer import fast_keywords
from cudavolumerenderer_tpu_torch.ops import fastbody as fb
from cudavolumerenderer_tpu_torch.ops import stages
from cudavolumerenderer_tpu_torch.ops.camera import make_camera
from cudavolumerenderer_tpu_torch.scene import types as ttypes
from cudavolumerenderer_tpu_torch.utils import occupancy as tocc
from test_torch_cuda import clone_state
from test_torch_fast_options import (
    CASCADE, assert_matches_jax, full_albedo_pair, medical,
)

torch.set_num_threads(2)

SOURCE = Path(fb.__file__).resolve().parents[1] / "csrc" / "fastbody.cu"


# -- (a) the gate ---------------------------------------------------------------

def config_fields(name: str, champion: bool = False) -> Config:
    """A BASELINE config's Config as baseline_configs.main builds it (the
    scene file is not read here)."""
    row = next(r for r in bc.rows(False) if r[0] == name)
    _, _, kernel, res, iters, tiles, _ = row
    return Config(scene_file="unused", kernel=kernel, iterations=iters,
                  resolution=(res, res), n_tiles=tiles, two_level=True,
                  **(bc.champion(name) if champion else {}))


def stage_routes(config: Config, n_lanes: int, device_type: str = "cuda"):
    """For each cascade stage of a render of n_lanes lanes under
    `config`'s keywords: (pool width, spec_k, whether the kernel runs it)."""
    kw = fast_keywords(config)
    widths = tfast._cascade_widths(n_lanes, kw["cascade_factor"],
                                   kw["min_width"] or tfast._MIN_WIDTH)
    plan = tfast.stage_plan(widths, spec_width=kw["spec_width"],
                            tail_spec=kw["tail_spec"],
                            tail_single_level=kw["tail_single_level"],
                            two_level=kw["two_level"])
    return [(w, p["spec_k"], fb.route(device_type, p["spec_k"]))
            for w, p in zip(widths, plan)]


#: (label, Config, lanes of one cascade): configs 1-3 render one tile of
#: res^2 lanes, config 4 all 100 of its 40^2 tiles in one cascade
CONFIGS = [
    ("1", config_fields("1_bucky_raw_256_20it"), 256 * 256),
    ("2", config_fields("2_medical_mhd_512"), 512 * 512),
    ("3", config_fields("3_hetvol_vdb_1024"), 1024 * 1024),
    ("4", config_fields("4_mitsubaxml_10x10_50it"), 100 * 40 * 40),
    ("2-champion", config_fields("2_medical_mhd_512", True), 512 * 512),
    ("1-champion", config_fields("1_bucky_raw_256_20it", True), 256 * 256),
    ("cli-default", cli.config_from_args(cli.build_parser().parse_args(
        ["scene.xml", "-k", "fastSK"])), 400 * 400),
]


@pytest.mark.parametrize("label, config, n_lanes", CONFIGS,
                         ids=[c[0] for c in CONFIGS])
def test_gate_sends_every_stage_of_the_configs_to_the_kernel(
        label, config, n_lanes):
    routes = stage_routes(config, n_lanes)
    assert len(routes) > 1
    assert all(kernel for _, _, kernel in routes), routes


def test_gate_keeps_deferred_ggx_eager():
    """defer_ggx 4: the card sends every stage to the kernels (the flush
    runs in them); the CPU and eager_body=True keep the eager body."""
    config = Config(scene_file="unused", kernel=Kernel.FAST_SK,
                    two_level=True, defer_ggx=4)
    routes = stage_routes(config, 512 * 512)
    assert len(routes) > 1 and all(k for _, _, k in routes)
    assert not any(k for _, _, k in stage_routes(config, 512 * 512, "cpu"))
    assert fb.stage_mode("cuda", 1, 0) == "drain"
    assert fb.stage_mode("cuda", 1, 0, eager_body=True) == "eager"


def test_gate_keeps_speculative_narrow_pools_eager():
    """tail_spec 4: the pools up to the tail width speculate, the wide
    ones take one step, and the card sends all of them to the kernels;
    the CPU and eager_body=True keep the eager body."""
    config = Config(scene_file="unused", kernel=Kernel.FAST_SK,
                    two_level=True, tail_spec=4)
    routes = stage_routes(config, 512 * 512)
    assert all(k for _, _, k in routes)
    spec = [w for w, k, _ in routes if k > 1]
    assert spec and spec == [w for w, _, _ in routes
                             if w <= tfast._TAIL_CHAIN_WIDTH]
    assert not any(k for _, _, k in stage_routes(config, 512 * 512, "cpu"))
    assert fb.route("cuda", 4) and not fb.route("cuda", 4, eager_body=True)
    assert fb.stage_mode("cuda", 4, 128) == "gated"
    assert fb.stage_mode("cuda", 4, 128, eager_body=True) == "eager"


def test_spec_k_beyond_the_kernels_limit_raises_on_the_card():
    """A spec_k above MAX_SPEC_K (at least 64) raises on a cuda device type
    (in route, stage_context and render_tile's check before any work): it
    never goes to the eager body quietly.  The CPU and eager_body=True run
    the eager body at any spec_k."""
    assert fb.MAX_SPEC_K >= 64
    assert fb.route("cuda", fb.MAX_SPEC_K)
    for k in (fb.MAX_SPEC_K + 1, 0):
        with pytest.raises(ValueError, match="spec_k"):
            fb.route("cuda", k)
        with pytest.raises(ValueError, match="spec_k"):
            fb.stage_mode("cuda", k, 0)
    assert not fb.route("cpu", fb.MAX_SPEC_K + 1)
    assert not fb.route("cuda", fb.MAX_SPEC_K + 1, eager_body=True)
    ctx = fb.BodyContext(
        fparams=np.zeros(fb.N_FP, np.float32),
        iparams=np.zeros(fb.N_IP, np.int64), table=torch.zeros(1),
        albedo_rows=None, brick_tab=None, tile_offset=None, bases=None)
    with pytest.raises(ValueError, match="spec_k"):
        fb.stage_context(ctx, None, True, None, spec_k=fb.MAX_SPEC_K + 1)
    assert fb.stage_context(ctx, None, True, None, spec_k=64).iparams[
        fb.IP_SPEC] == 64


def test_gate_keeps_the_cpu_and_eager_callers_eager():
    assert not any(k for _, _, k in stage_routes(CONFIGS[1][1], 512 * 512,
                                                 "cpu"))
    assert fb.route("cuda", 1) and not fb.route("cuda", 1, eager_body=True)


# -- (b) the parameter vectors ------------------------------------------------

def captured_contexts(monkeypatch, scene, camera, settings, res, spp, **kw):
    """The stage contexts render_tile builds on the CPU with the gate
    forced open (run_body then runs the eager body on the CPU tensors),
    and the render's (image, n_rays)."""
    ctxs = []
    run = fb.run_body
    monkeypatch.setattr(fb, "route", lambda *a, **k: True)

    def keep(ctx, s, out=None):
        ctxs.append(ctx)
        return run(ctx, s, out)

    monkeypatch.setattr(fb, "run_body", keep)
    out = tfast.render_tile(scene, camera, settings, (res, res),
                            torch.zeros(2), (res, res), spp, 7, 5, **kw)
    return ctxs, out


@pytest.mark.parametrize("two_level", [False, True], ids=["one", "two"])
def test_parameters_equal_render_tiles_values(monkeypatch, two_level):
    """inv_sigmat, res_minus_1, extent, the brick geometry, epsw, the
    albedo's A and B and the rest, each as render_tile computes it (on the
    CPU, so a division is a true division); and with the gate forced open
    the render equals the plain render (the kernel's pending count is the
    caller's count on the CPU)."""
    scene, _ = medical((16, 20, 24))  # a grid of three distinct sides
    med = scene.medium
    cam = make_camera(24, 24, device="cpu")
    settings = ttypes.RenderSettings.from_flags(True)
    kw = dict(two_level=two_level, **CASCADE)
    ctxs, out = captured_contexts(monkeypatch, scene, cam, settings, 24, 4,
                                  **kw)
    monkeypatch.undo()
    want = tfast.render_tile(scene, cam, settings, (24, 24), torch.zeros(2),
                             (24, 24), 4, 7, 5, **kw)
    assert torch.equal(out[0], want[0]) and float(out[1]) == float(want[1])
    assert len(ctxs) > 3
    f32 = np.float32
    nz, ny, nx = med.density.data.shape
    box_min, box_max = med.box_min.numpy(), med.box_max.numpy()
    extent = box_max - box_min
    for ctx in ctxs:
        f, i = ctx.fparams, ctx.iparams
        assert f.dtype == np.float32 and i.dtype == np.int64
        assert f[fb.FP_INV_SIGMAT] == f32(1) / (f32(med.scale) *
                                                 f32(med.max_density))
        np.testing.assert_array_equal(f[fb.FP_RM1:fb.FP_RM1 + 3],
                                      [nx - 1, ny - 1, nz - 1])
        np.testing.assert_array_equal(f[fb.FP_EXT:fb.FP_EXT + 3], extent)
        np.testing.assert_array_equal(f[fb.FP_BMIN:fb.FP_BMIN + 3], box_min)
        np.testing.assert_array_equal(f[fb.FP_BMAX:fb.FP_BMAX + 3], box_max)
        assert f[fb.FP_EPSW] == f32(extent.max()) * f32(1e-6)
        np.testing.assert_array_equal(f[fb.FP_ALB_A:fb.FP_ALB_A + 3],
                                      med.albedo_affine[0].numpy())
        np.testing.assert_array_equal(f[fb.FP_ALB_B:fb.FP_ALB_B + 3],
                                      med.albedo_affine[1].numpy())
        assert i[fb.IP_ALBEDO] == fb.ALBEDO_MODES["affine"]
        assert f[fb.FP_SCALE] == f32(med.scale) and f[fb.FP_G] == f32(med.g)
        assert f[fb.FP_INV_TW] == f32(1) / f32(24)
        assert f[fb.FP_INV_RESX] == f[fb.FP_INV_RESY] == f32(1) / f32(24)
        np.testing.assert_array_equal(f[fb.FP_CAM:fb.FP_CAM + 12],
                                      cam.inv_view.numpy().reshape(-1))
        assert f[fb.FP_INV_ETA] == f32(1) / f32(scene.bsdf.eta)
        assert (i[fb.IP_NX], i[fb.IP_NY], i[fb.IP_NZ]) == (nx, ny, nz)
        assert (i[fb.IP_SPP], i[fb.IP_M], i[fb.IP_NPIX], i[fb.IP_TW]) == (
            4, 1, 576, 24)
        assert i[fb.IP_BASE] == 5 and i[fb.IP_MULTI] == 0
        assert i[fb.IP_SEEDH] == (7 * 0x9E3779B9) & 0xFFFFFFFF
        assert i[fb.IP_TABLE] == fb.TAB_F32 and i[fb.IP_BSDF] == 1
        assert i[fb.IP_TWO_LEVEL] == int(two_level)
        if two_level:
            bz, by, bx = tfast.pick_brick((nz, ny, nx))
            np.testing.assert_array_equal(f[fb.FP_BSIZE:fb.FP_BSIZE + 3],
                                          [bx, by, bz])
            nbz, nby, nbx = -(-nz // bz), -(-ny // by), -(-nx // bx)
            assert (i[fb.IP_NBX], i[fb.IP_NBY]) == (nbx, nby)
            assert tuple(i[fb.IP_HIX:fb.IP_HIZ + 1]) == (nbx - 1, nby - 1,
                                                         nbz - 1)
            assert ctx.brick_tab.shape == (nbz * nby * nbx, 2)
        else:
            assert ctx.brick_tab is None


def test_parameters_of_tables_and_tiles(monkeypatch):
    """The packed table's dequantizing factor and bits, the 'full' rows,
    a constant albedo, and multi-tile mode's offsets and masked bases."""
    d = procedural.medical_volume((16, 16, 16), n_blobs=4).astype(np.float32)
    cam = make_camera(16, 16, device="cpu")
    settings = ttypes.RenderSettings.from_flags(True, bsdf_kind="null")
    const = ttypes.make_scene(ttypes.make_medium(d, 0.7, scale=20.0,
                                                 max_density=1.0,
                                                 device="cpu"))
    ctx = captured_contexts(monkeypatch, const, cam, settings, 16, 2,
                            table_bits=4)[0][0]
    assert ctx.iparams[fb.IP_TABLE] == fb.TAB_PACKED
    assert ctx.iparams[fb.IP_BITS] == 4 and ctx.iparams[fb.IP_BSDF] == 0
    assert ctx.fparams[fb.FP_QSCALE] == np.float32(1.0) / np.float32(15.0)
    assert ctx.iparams[fb.IP_ALBEDO] == fb.ALBEDO_MODES["const"]
    np.testing.assert_array_equal(ctx.fparams[fb.FP_ALB_B:fb.FP_ALB_B + 3],
                                  np.float32(0.7))
    assert ctx.table.dtype == torch.int32
    monkeypatch.undo()

    full, _ = full_albedo_pair((16, 16, 16))
    ctx = captured_contexts(monkeypatch, full, cam, settings, 16, 2)[0][0]
    assert ctx.iparams[fb.IP_TABLE] == fb.TAB_ROWS
    assert ctx.iparams[fb.IP_ALBEDO] == fb.ALBEDO_MODES["full"]
    assert ctx.table.shape == (16 ** 3, 4)
    monkeypatch.undo()

    ctxs = []
    run = fb.run_body
    monkeypatch.setattr(fb, "route", lambda *a, **k: True)
    monkeypatch.setattr(fb, "run_body",
                        lambda ctx, s, out=None: (ctxs.append(ctx),
                                                  run(ctx, s, out))[1])
    offsets = torch.tensor([[0, 0], [8, 0], [0, 8], [8, 8]],
                           dtype=torch.float32)
    bases = torch.tensor([0, 256, 1 << 32, (1 << 32) + 5])
    tfast.render_tile(full, cam, settings, (8, 8), offsets, (16, 16), 4, 3,
                      bases)
    ctx = ctxs[0]
    assert ctx.iparams[fb.IP_MULTI] == 1 and ctx.iparams[fb.IP_NPIX] == 64
    assert torch.equal(ctx.tile_offset, offsets)
    assert ctx.bases.tolist() == [0, 256, 0, 5]


def enum_values(source: str) -> dict:
    """Every name of the `enum { ... }` blocks of a C source, with its
    value (implicit values count on from the last one)."""
    names = {}
    for block in re.findall(r"enum\s*\{(.*?)\};", source, re.S):
        block = re.sub(r"//[^\n]*", "", block)
        value = -1
        for item in filter(None, (x.strip() for x in block.split(","))):
            if "=" in item:
                name, expr = (x.strip() for x in item.split("=", 1))
                value = eval(expr, {}, dict(names))  # noqa: S307
            else:
                name, value = item, value + 1
            names[name] = value
    return names


def test_kernel_layout_equals_the_wrappers():
    """csrc/fastbody.cu's FP_*, IP_*, S_* and mode enums give the values
    ops/fastbody.py packs by, so the card reads what the CPU wrote."""
    c = enum_values(SOURCE.read_text())
    py = {k: v for k, v in vars(fb).items()
          if re.fullmatch(r"(FP|IP|S|N|TAB)_[A-Z0-9_]+", k)
          and isinstance(v, int)}
    lane = {f"S_{n}": k for k, n in enumerate(
        ("O", "D", "TP", "ACC", "NRM", "T", "MAXT", "BEXIT", "ISL", "SD",
         "BOUNCE", "ALIVE", "TRACKING", "RS", "RINC", "PEND"))}
    assert {k: c[k] for k in lane} == lane
    assert c["N_LANE"] == fb.N_LANE == len(fb.LANE_FIELDS)
    assert fb.LANE_FIELDS[fb.S_PEND] == "pend_b"
    # the speculative steps' and the deferred flush's slots
    for name in ("IP_SPEC", "IP_DEFER", "S_PEND"):
        assert c[name] == getattr(fb, name), name
    shared = sorted(set(c) & set(py))
    assert len(shared) >= 60
    assert {k: c[k] for k in shared} == {k: py[k] for k in shared}
    assert {k: c[f"ALB_{n}"] for k, n in (
        ("const", "CONST"), ("affine", "AFFINE"), ("full", "ROW"),
        ("split", "SPLIT"))} == fb.ALBEDO_MODES


def test_body_bytes_counts_state_and_distinct_taps():
    ctx = fb.BodyContext(
        fparams=np.zeros(fb.N_FP, np.float32),
        iparams=np.zeros(fb.N_IP, np.int64), table=torch.zeros(1),
        albedo_rows=None, brick_tab=None, tile_offset=None, bases=None)
    yes, no = torch.tensor([True] * 3), torch.tensor([False] * 3)
    # per lane, the fields it reads and the ones it changes: three alive
    # flags read, one written; one lane's o read and written
    state = {"alive": (yes, torch.tensor([False, True, False])),
             "o": (torch.tensor([True, False, False]),) * 2,
             "accum": (no, no)}
    lanes = 3 + 1 + 2 * 12
    taps = [("state", state), ("tap", torch.tensor([3, 3, 9])),
            ("brick", torch.tensor([1, 1])), ("tap", torch.tensor([9, 12]))]
    assert fb.body_bytes(ctx, taps) == lanes + 3 * 4 + 8
    ctx.iparams[fb.IP_TABLE], ctx.iparams[fb.IP_BITS] = fb.TAB_PACKED, 4
    # packed: voxels 3, 9 and 12 share word 3, 9, 12 of row group 0
    assert fb.body_bytes(ctx, taps) == lanes + 3 * 4 + 8
    j = torch.tensor([0, 128, 8 * 128, 8 * 128 + 1])  # words 0, 0, 128, 129
    assert fb.body_bytes(ctx, [("tap", j)]) == 3 * 4


def test_run_body_raises_on_other_devices():
    s = tfast.FastState(*[torch.zeros(1, device="meta")] * 20)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        fb.run_body(None, s)


# -- (c) the eager body against JAX ------------------------------------------

def render_pair(pair, settings_kw, res=16, spp=4, seed=7, eager=False, **kw):
    """with_stats renders of both packages (port first) as numpy; JAX op by
    op with eager."""
    ts, js = pair
    jc = jcam.make_camera(res, res)
    tc = convert.camera_from_arrays(jc.inv_view, jc.raster_to_view)
    t = tfast.render_tile(
        ts, tc, ttypes.RenderSettings.from_flags(True, **settings_kw),
        (res, res), torch.zeros(2), (res, res), spp, seed, 0,
        with_stats=True, **kw)
    with jax.disable_jit(eager):
        j = jfast.render_tile(
            js, jc, jtypes.RenderSettings.from_flags(True, **settings_kw),
            (res, res), jnp.zeros(2), (res, res), spp, seed, 0,
            with_stats=True, **kw)
    return [np.asarray(x) for x in t], [np.asarray(x) for x in j]


#: (id, scene pair maker, settings, render_tile keywords, JAX op by op):
#: GGX renders hold JAX op by op, where XLA's CPU jit contracting
#: `a * b + c` into fmas moves a path or two (ROADMAP, "XLA's CPU jit")
EAGER_CASES = [
    ("full-2l", lambda: full_albedo_pair((16, 16, 16)), dict(bsdf_kind="null"),
     dict(two_level=True), False),
    ("full-1l-ggx", lambda: full_albedo_pair((16, 16, 16)), {},
     dict(two_level=False), True),
    ("m2-2l", medical, dict(bsdf_kind="null"),
     dict(two_level=True, lanes_per_pixel=2), False),
    ("one-level-ggx", medical, {}, dict(two_level=False), True),
    ("rr-off-cap", medical, dict(bsdf_kind="null", russian_roulette=False,
                                 max_path_length=5),
     dict(two_level=True), False),
    ("rr-off-ggx", medical, dict(russian_roulette=False), dict(two_level=False),
     True),
]


@pytest.mark.parametrize("case", EAGER_CASES, ids=[c[0] for c in EAGER_CASES])
def test_eager_body_matches_jax(case):
    _, make, settings_kw, kw, eager = case
    t, j = render_pair(make(), settings_kw, eager=eager, **{**CASCADE, **kw})
    assert_matches_jax(t, j)


def test_split_eager_body_matches_jax(monkeypatch):
    """'split' two-level with one Woodcock step per evaluation (the
    kernel's mode; tests/test_torch_fast_options.py holds spec4): a
    budget of 40 bytes per voxel sends the 16x18x20 per-voxel albedo to
    'split' in both packages; JAX decides the mode when it traces, so its
    caches are cleared and the grid's shape is used by no other test."""
    shape = (16, 18, 20)
    pair = full_albedo_pair(shape)
    budget = 40 * int(np.prod(shape))
    monkeypatch.setattr(tocc, "device_memory_budget", lambda device=None:
                        budget)
    monkeypatch.setattr(jocc, "device_memory_budget", lambda: budget)
    assert tfast._albedo_mode(pair[0], allow_split=True) == "split"
    assert jfast._albedo_mode(pair[1], allow_split=True) == "split"
    jax.clear_caches()
    t, j = render_pair(pair, dict(bsdf_kind="null"), two_level=True,
                       **CASCADE)
    assert_matches_jax(t, j)
    jax.clear_caches()



# -- (d) the stage path: run_stage, its drain and its gated chains ------------

def pending_lanes(s, spp: int) -> torch.Tensor:
    return s.alive | (s.samples_done < spp)


def lane_fields(s):
    """(name, per-lane tensor) of every field the body may update."""
    return [(name, stages.lane_field(s, name)) for name in fb.LANE_FIELDS]


def same(x, y):
    """Equal bit for bit as values (NaN equal to NaN)."""
    if x.is_floating_point():
        return bool(((x == y) | (torch.isnan(x) & torch.isnan(y))).all())
    return bool((x == y).all())


def stage_render(monkeypatch, scene, settings, res, spp, cam=None, base=5,
                 **kw):
    """A with_stats CPU render of `scene` (seed 7) with the gate forced
    open, so render_tile hands every kernel-routed stage to run_stage (on
    the CPU its loop of plain evaluations); returns the render and, per
    stage, (ctx, the entry state, thresh, k_chain, last)."""
    stages = []
    run = fb.run_stage
    monkeypatch.setattr(fb, "route", lambda *a, **k: True)

    def keep(ctx, s, thresh, k_chain, last):
        stages.append((ctx, clone_state(s), thresh, k_chain, last))
        return run(ctx, s, thresh, k_chain, last)

    monkeypatch.setattr(fb, "run_stage", keep)
    cam = make_camera(res, res, device="cpu") if cam is None else cam
    out = tfast.render_tile(scene, cam, settings, (res, res), torch.zeros(2),
                            (res, res), spp, 7, base, with_stats=True, **kw)
    monkeypatch.undo()
    return out, stages


def lane_lengths(ctx, s) -> torch.Tensor:
    """Per lane, the plain body's evaluations until the lane is no longer
    pending (0 for a lane that is not pending now)."""
    spp = int(ctx.iparams[fb.IP_SPP])
    length = torch.zeros(s.alive.shape[0], dtype=torch.int64)
    s, n = clone_state(s), 0
    while bool(pending_lanes(s, spp).any()):
        s, n = ctx.plain(s), n + 1
        length = torch.where((length == 0) & ~pending_lanes(s, spp), n,
                             length)
    return length


FIXED_POINT_CASES = [
    ("ggx-2l", {}, True), ("ggx-1l", {}, False),
    ("null-2l", dict(bsdf_kind="null"), True),
    ("null-1l", dict(bsdf_kind="null"), False),
]


@pytest.mark.parametrize("case", FIXED_POINT_CASES,
                         ids=[c[0] for c in FIXED_POINT_CASES])
def test_non_pending_lane_is_a_fixed_point_of_the_body(monkeypatch, case):
    """Along the last stage of a 16^3 render, every lane that is not
    pending (no path in flight, no sample left) leaves an evaluation of
    the plain body with every field as it was; once no lane is pending,
    an evaluation adds nothing to n_rays and n_busy and the width to
    n_rows.  So the drain may stop a lane at its end (the loop's later
    evaluations would not move it) and fold counts of 0 for it."""
    _, settings_kw, two_level = case
    scene = medical()[0]
    settings = ttypes.RenderSettings.from_flags(True, **settings_kw)
    _, stages = stage_render(monkeypatch, scene, settings, 24, 4,
                             two_level=two_level, **CASCADE)
    ctx, s, thresh, _, last = stages[-1]
    assert thresh == 0 and last
    spp = int(ctx.iparams[fb.IP_SPP])
    done_lanes, n = 0, 0
    while bool(pending_lanes(s, spp).any()):
        idle = ~pending_lanes(s, spp)
        nxt = ctx.plain(clone_state(s))
        for (name, x), (_, y) in zip(lane_fields(s), lane_fields(nxt)):
            assert same(x[idle], y[idle]), (name, n)
        done_lanes, n, s = max(done_lanes, int(idle.sum())), n + 1, nxt
    assert n > 10 and done_lanes > 0
    nxt = ctx.plain(clone_state(s))
    for (name, x), (_, y) in zip(lane_fields(s), lane_fields(nxt)):
        assert same(x, y), name
    width = s.alive.shape[0]
    assert float(nxt.n_rays) == float(s.n_rays)
    assert float(nxt.n_busy) == float(s.n_busy)
    assert float(nxt.n_rows) == float(s.n_rows + float(width))


def fold(n0: float, counts) -> np.float32:
    """The drain's fold: n0 + counts[0] + counts[1] + ... in float32, one
    add at a time in order (np.add.accumulate does not pair)."""
    seq = np.concatenate([[np.float32(n0)], np.asarray(counts, np.float32)])
    return np.add.accumulate(seq, dtype=np.float32)[-1]


@pytest.mark.parametrize("n0, width, n_evals", [
    (0.0, 16384, 3002), (16777215.0, 262144, 64), (1.5e7, 65536, 500)])
def test_ordered_float32_fold_equals_sequential_adds(n0, width, n_evals):
    """Per-evaluation integer counts folded in float32 in evaluation order
    give the loop's counters (n + the evaluation's float32 sum, one
    evaluation at a time), past 2^24 where float32 stops being exact and
    the order matters: summing the integers first gives another value."""
    gen = np.random.default_rng(n_evals)
    counts = gen.integers(0, width + 1, n_evals)
    counts[::7] = 0  # evaluations past a lane's end count nothing
    n = torch.tensor(n0, dtype=torch.float32)
    rows = torch.tensor(n0, dtype=torch.float32)
    for c in counts:
        n = n + torch.ones(int(c), dtype=torch.float32).sum()
        rows = rows + float(width)
    assert fold(n0, counts) == n.numpy()
    assert fold(n0, np.full(n_evals, width)) == rows.numpy()
    assert float(n) > 2 ** 24
    assert np.float32(np.float64(n0) + counts.sum()) != n.numpy()


STAGE_CASES = [
    ("cascade2-chain1", 24, dict(two_level=True, **CASCADE)),
    ("cascade2-chain8", 32, dict(two_level=True, cascade_factor=2,
                                 min_width=256)),
    ("champion", 48, fast_keywords(config_fields("2_medical_mhd_512", True))),
]


@pytest.mark.parametrize("case", STAGE_CASES, ids=[c[0] for c in STAGE_CASES])
def test_drain_evaluations_equal_the_loops(monkeypatch, case):
    """E = k_chain * ceil(L / k_chain), L the longest lane's evaluations
    to its end, equals the evaluations the loop made in the last stage
    (stage_rows / width), on CPU renders; --champion's cascade 1.25 with
    min_width 64 and q4 tables too."""
    _, res, kw = case
    scene = medical()[0]
    settings = ttypes.RenderSettings.from_flags(True)
    out, stages = stage_render(monkeypatch, scene, settings, res, 4, **kw)
    assert len(stages) > 1 and len(stages) == len(out[4])
    ctx, s, thresh, k_chain, last = stages[-1]
    assert thresh == 0 and last
    length = int(lane_lengths(ctx, s).max())
    evals = k_chain * -(-length // k_chain)
    width = s.alive.shape[0]
    assert length > 0 and evals == float(out[4][-1]) / width


#: (id, scene pair maker, settings, render_tile keywords, against JAX too):
#: JAX compiles a chain of 8 evaluations for ~2 minutes, so that case holds
#: the port's eager loop only
RUN_STAGE_CASES = [
    ("null-2l", medical, dict(bsdf_kind="null"), dict(two_level=True), True),
    ("full-1l", lambda: full_albedo_pair((16, 16, 16)), dict(bsdf_kind="null"),
     dict(two_level=False), True),
    ("chain8-2l", medical, {}, dict(two_level=True, tail_chain=8), False),
]


@pytest.mark.parametrize("case", RUN_STAGE_CASES,
                         ids=[c[0] for c in RUN_STAGE_CASES])
def test_run_stage_equals_the_loop_and_jax(monkeypatch, case):
    """render_tile through run_stage (the gate forced open on the CPU)
    leaves the image, n_rays, n_rows, n_busy and the per-stage rows as the
    eager loop does, bit for bit, and agrees with JAX's render_tile under
    the tolerances of assert_matches_jax."""
    _, make, settings_kw, kw, with_jax = case
    pair = make()
    kw = {**CASCADE, **kw}
    jc = jcam.make_camera(24, 24)
    forced, stages = stage_render(
        monkeypatch, pair[0], ttypes.RenderSettings.from_flags(True,
                                                               **settings_kw),
        24, 4, cam=convert.camera_from_arrays(jc.inv_view, jc.raster_to_view),
        base=0, **kw)
    assert len(stages) == len(forced[4]) > 1
    if with_jax:
        t, j = render_pair(pair, settings_kw, res=24, **kw)
        assert_matches_jax([np.asarray(x) for x in forced], j)
    else:
        t = tfast.render_tile(
            pair[0], convert.camera_from_arrays(jc.inv_view, jc.raster_to_view),
            ttypes.RenderSettings.from_flags(True, **settings_kw), (24, 24),
            torch.zeros(2), (24, 24), 4, 7, 0, with_stats=True, **kw)
    for x, y in zip(forced, t):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_stage_mode_by_threshold_and_gate():
    assert fb.stage_mode("cuda", 1, 0) == "drain"
    assert fb.stage_mode("cuda", 1, 128) == "gated"
    assert fb.stage_mode("cuda", 1, 4096) == "gated"
    assert fb.stage_mode("cuda", 4, 0) == "drain"
    assert fb.stage_mode("cuda", 16, 512) == "gated"
    assert fb.stage_mode("cuda", 1, 0, eager_body=True) == "eager"
    assert fb.stage_mode("cpu", 1, 0) == "eager"
    assert fb.stage_mode("cpu", 1, 128) == "eager"


@pytest.mark.parametrize("tail_pallas", [False, True], ids=["drain", "tail"])
def test_stage_mode_of_render_tiles_stages(monkeypatch, tail_pallas):
    """The thresholds render_tile hands run_stage: only the last stage of
    a render without the tail kernel has 0 and drains; with the tail
    kernel the last stage exits at its width and runs gated, as every
    wider stage does."""
    scene = medical()[0]
    settings = ttypes.RenderSettings.from_flags(True, bsdf_kind="null")
    out, stages = stage_render(monkeypatch, scene, settings, 24, 2,
                               two_level=True, tail_pallas=tail_pallas,
                               tail_pk_width=128, **CASCADE)
    modes = [fb.stage_mode("cuda", 1, thresh)
             for _, _, thresh, _, _ in stages]
    assert [last for *_, last in stages] == [False] * (len(stages) - 1) + [
        True]
    assert modes == ["gated"] * (len(stages) - 1) + [
        "gated" if tail_pallas else "drain"]
    assert stages[-1][2] == (128 if tail_pallas else 0)
    assert len(out[4]) == len(stages) + tail_pallas


def test_control_words_layout_equals_the_wrappers():
    """csrc/common.cuh's C_* control words and N_CTRL (the ones fastbody.cu
    reads) give the indices ops/stages.py reads the stage's control words
    at, and fastbody.cu defines none of its own."""
    c = enum_values((SOURCE.parent / "common.cuh").read_text())
    py = {k: v for k, v in vars(stages).items()
          if re.fullmatch(r"C_[A-Z_]+|N_CTRL", k) and isinstance(v, int)}
    assert len(py) == 9
    assert {k: c[k] for k in py} == py
    assert not set(py) & set(enum_values(SOURCE.read_text()))
    assert fb.N_CTRL == stages.N_CTRL


def test_body_reports_per_lane_traffic(monkeypatch):
    """The eager body's taps leave its result unchanged and report each
    lane's reads and changed fields (body_bytes counts per lane): a lane
    with no path in flight and no sample left reads its alive flag and its
    sample count and writes nothing, so the bound lies under the whole
    state's 236 B a lane."""
    scene = medical()[0]
    settings = ttypes.RenderSettings.from_flags(True)
    _, stages_ = stage_render(monkeypatch, scene, settings, 24, 4,
                              two_level=True, **CASCADE)
    ctx, s, _, _, _ = stages_[-1]
    spp = int(ctx.iparams[fb.IP_SPP])
    for _ in range(40):  # on into the last stage, where lanes have ended
        s = ctx.plain(s)
    idle = ~pending_lanes(s, spp)
    assert idle.any() and (~idle).any()
    taps = []
    got = ctx.plain(clone_state(s), taps=taps)
    want = ctx.plain(clone_state(s))
    for (name, x), (_, y) in zip(lane_fields(got), lane_fields(want)):
        assert same(x, y), name
    (traffic,) = [x for k, x in taps if k == "state"]
    for name, (read, written) in traffic.items():
        assert not written[idle].any(), name
        assert bool(read[idle].all()) == (name in ("alive", "samples_done")), name
    width = s.alive.shape[0]
    n = fb.body_bytes(ctx, taps)
    assert 0 < n - fb.body_bytes(ctx, [x for x in taps if x[0] != "state"])
    assert fb.body_bytes(ctx, [("state", traffic)]) < width * 236


# -- (e) the speculative steps and the deferred flush on the stage path -------

def host_schedule(widths, counts, defer):
    """render_tile's step(): per evaluation of the pools `widths` (counts[k]
    evaluations of widths[k]), whether its flush runs, from the host's
    float32 copy of n_rows; and the device's n_rows before each, summed by
    torch in float32 as the body adds it."""
    rows_host = np.float32(0.0)
    n_rows = torch.zeros((), dtype=torch.float32)
    flags, dev = [], []
    for width, n in zip(widths, counts):
        w = np.float32(width)
        for _ in range(n):
            flags.append(int(np.round(rows_host / w)) % defer == 0)
            dev.append((float(n_rows), width))
            rows_host = np.float32(rows_host + w)
            n_rows = n_rows + float(width)
    return flags, dev, rows_host


@pytest.mark.parametrize("defer", [1, 3, 4])
def test_flush_schedule_equals_the_hosts_loop(defer):
    """fastbody.flush_due, the plain function csrc/fastbody.cu mirrors
    (IEEE float32 division of the evaluation's n_rows by the width, rintf,
    modulo defer_ggx), on the device's float32 n_rows gives the flags of
    render_tile's host loop on its numpy copy, through a cascade of 1.25
    (widths no powers of two) run past 2^24 rows, where float32 sums
    round; the round is half to even."""
    widths = tfast._cascade_widths(1 << 18, 1.25, 256)
    assert any(w & (w - 1) for w in widths)
    counts = [40 + 7 * k for k in range(len(widths))]
    flags, dev, rows_host = host_schedule(widths, counts, defer)
    got = [fb.flush_due(n, w, defer) for n, w in dev]
    assert got == flags and any(flags) and (defer == 1 or not all(flags))
    assert dev[-1][0] > 2 ** 24
    assert float(dev[-1][0] + widths[-1]) == float(rows_host)
    # ties: 640 / 256 = 2.5 rounds to 2, 896 / 256 = 3.5 to 4
    assert fb.flush_due(640.0, 256, 2) and fb.flush_due(896.0, 256, 4)
    assert not fb.flush_due(640.0, 256, 3)
    assert not fb.flush_due(0.0, 256, 0)


#: (id, render_tile keywords, against JAX's render too): the stage path
#: under tail_spec (two- and single-level) and defer_ggx; JAX stands beside
#: it where tests/test_torch_fast_options.py holds the mode under jit
MODE_STAGE_CASES = [
    ("spec4-2l", dict(two_level=True, tail_spec=4), False),
    ("spec4-2l-q4", dict(two_level=True, tail_spec=4, table_bits=4), True),
    ("single8", dict(two_level=True, tail_single_level=True, tail_spec=8),
     False),
    ("defer1-2l", dict(two_level=True, defer_ggx=1), False),
    ("defer4-2l", dict(two_level=True, defer_ggx=4), True),
    ("defer4-1l-spec4", dict(two_level=False, defer_ggx=4, tail_spec=4),
     False),
]


@pytest.mark.parametrize("case", MODE_STAGE_CASES,
                         ids=[c[0] for c in MODE_STAGE_CASES])
def test_run_stage_in_the_speculative_and_deferred_modes(monkeypatch, case):
    """render_tile through run_stage with the gate forced open on the CPU
    (each stage's loop of plain evaluations: the flush read from the
    state's n_rows, then the body) gives the eager loop's image, n_rays,
    n_rows, n_busy and per-stage rows bit for bit, every stage in the
    mode it names; with_stats' check of the host's n_rows against the
    device's holds; and it agrees with JAX's render_tile where a JAX
    render stands beside it."""
    _, kw, with_jax = case
    pair = medical()
    kw = {**CASCADE, **kw}
    jc = jcam.make_camera(24, 24)
    cam = convert.camera_from_arrays(jc.inv_view, jc.raster_to_view)
    settings = ttypes.RenderSettings.from_flags(True, bsdf_kind="null")
    forced, kept = stage_render(monkeypatch, pair[0], settings, 24, 4,
                                cam=cam, base=0, **kw)
    assert len(kept) == len(forced[4]) > 1
    modes = [fb.modes_of(ctx) for ctx, *_ in kept]
    if kw.get("defer_ggx"):
        assert all("defer" in m for m in modes)
    if kw.get("tail_spec"):
        assert any("spec" in m for m in modes)
    t = tfast.render_tile(pair[0], cam, settings, (24, 24), torch.zeros(2),
                          (24, 24), 4, 7, 0, with_stats=True, **kw)
    for x, y in zip(forced, t):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    if with_jax:
        _, j = render_pair(pair, {"bsdf_kind": "null"}, res=24, **kw)
        assert_matches_jax([np.asarray(x) for x in forced], j)


@pytest.mark.parametrize("valid, accept, want", [
    ("1111", "0101", "1100"),  # the first acceptance ends the rows read
    ("1110", "0000", "1110"),  # an invalid candidate reads no row
    ("1111", "0000", "1111"),  # no stop: every candidate's row
    ("0000", "0000", "0000"),  # a lane that does not step
    ("1100", "1000", "1000"),
], ids=["accept", "invalid", "none", "idle", "first"])
def test_speculative_taps_stop_at_the_first_acceptance(valid, accept, want):
    """read_prefix, the candidates whose rows a speculative step needs (and
    body_bytes counts): the valid ones up to and including the first
    acceptance, or all valid ones where none accepts."""
    rows = lambda x: torch.tensor([[c == "1" for c in x]])  # noqa: E731
    got = tfast.read_prefix(rows(accept), rows(valid))
    assert torch.equal(got, rows(want))


def test_speculative_and_deferred_bounds_count_their_taps(monkeypatch):
    """The eager body's taps under tail_spec name the table entries of the
    valid candidates up to the first acceptance (so a speculative stage's
    bound counts table bytes, and no more than the step needs), and
    under defer_ggx pend_b (1 B) and the flush's fields join the state
    traffic; without defer_ggx pend_b is not counted."""
    scene = medical()[0]
    settings = ttypes.RenderSettings.from_flags(True)
    for kw, defer in ((dict(tail_spec=4, tail_single_level=True), 0),
                      (dict(defer_ggx=1), 1)):
        _, kept = stage_render(monkeypatch, scene, settings, 24, 4,
                               two_level=True, **CASCADE, **kw)
        ctx, s = kept[-1][:2]
        taps = []
        for _ in range(3):
            s = ctx.plain(s, taps=taps)
        traffic = [x for k, x in taps if k == "state"]
        assert all(("pend_b" in x) == bool(defer) for x in traffic)
        if defer:
            assert len(traffic) > 3  # a flush each evaluation
        else:
            assert ctx.iparams[fb.IP_SPEC] == 4
            tap_idx = [x for k, x in taps if k == "tap"]
            assert tap_idx and sum(x.numel() for x in tap_idx) > 0
        assert fb.body_bytes(ctx, taps) > fb.body_bytes(
            ctx, [x for x in taps if x[0] == "state"])
