"""fastSK's body kernel (csrc/fastbody.cu, ops/fastbody.py) on the CPU,
which has no card: the gate that sends a stage to the kernel or to the
eager body, the kernel's parameter vectors against the values
render_tile computes, the C layout against the Python one, and the eager
body (the kernel's plain version) against JAX's render_tile for the
modes the kernel covers that no other test holds: the 'full' and 'split'
albedo tables, two lanes per pixel, one-level GGX and Russian roulette
off.  The kernel against the eager body, bit for bit, is in
tests/test_torch_cuda.py (card tests)."""

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
from cudavolumerenderer_tpu_torch.ops.camera import make_camera
from cudavolumerenderer_tpu_torch.scene import types as ttypes
from cudavolumerenderer_tpu_torch.utils import occupancy as tocc
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
    return [(w, p["spec_k"], fb.route(device_type, p["spec_k"],
                                      kw["defer_ggx"]))
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
    config = Config(scene_file="unused", kernel=Kernel.FAST_SK,
                    two_level=True, defer_ggx=4)
    assert not any(k for _, _, k in stage_routes(config, 512 * 512))


def test_gate_keeps_speculative_narrow_pools_eager():
    """tail_spec 4: the pools up to the tail width speculate (eager), the
    wide ones take one step (the kernel)."""
    config = Config(scene_file="unused", kernel=Kernel.FAST_SK,
                    two_level=True, tail_spec=4)
    routes = stage_routes(config, 512 * 512)
    assert [k for _, _, k in routes] == [spec == 1 for _, spec, _ in routes]
    eager = [w for w, _, k in routes if not k]
    assert eager and eager == [w for w, _, _ in routes
                               if w <= tfast._TAIL_CHAIN_WIDTH]


def test_gate_keeps_the_cpu_and_eager_callers_eager():
    assert not any(k for _, _, k in stage_routes(CONFIGS[1][1], 512 * 512,
                                                 "cpu"))
    assert fb.route("cuda", 1, 0) and not fb.route("cuda", 1, 0,
                                                   eager_body=True)


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
         "BOUNCE", "ALIVE", "TRACKING", "RS", "RINC"))}
    assert {k: c[k] for k in lane} == lane
    assert c["N_LANE"] == fb.N_LANE == len(fb.LANE_FIELDS)
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
    taps = [("tap", torch.tensor([3, 3, 9])), ("brick", torch.tensor([1, 1])),
            ("tap", torch.tensor([9, 12]))]
    assert fb.body_bytes(ctx, 10, taps) == 10 * 236 + 3 * 4 + 8
    ctx.iparams[fb.IP_TABLE], ctx.iparams[fb.IP_BITS] = fb.TAB_PACKED, 4
    # packed: voxels 3, 9 and 12 share word 3, 9, 12 of row group 0
    assert fb.body_bytes(ctx, 10, taps) == 10 * 236 + 3 * 4 + 8
    j = torch.tensor([0, 128, 8 * 128, 8 * 128 + 1])  # words 0, 0, 128, 129
    assert fb.body_bytes(ctx, 1, [("tap", j)]) == 236 + 3 * 4


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

