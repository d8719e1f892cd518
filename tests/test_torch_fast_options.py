"""fastSK's options in the port against the JAX package
(models/fast.py): deferred boundary events (defer_ggx), speculative and
single-level tail pools (tail_spec, tail_single_level, spec_width), finer
tail bricks (tail_bricks), the 'split' albedo table, the brick-major
layout, and utils/occupancy.autotune_report.

The same numpy scene goes through JAX's render_tile and the port's at
16^2-24^2 x 4 with the null boundary, where the two packages agree: ray
counts exactly, images within JAX_TOL.  The cascades are cut to several
stages (min_width 256) so tail pools, the flush schedule across stages and
compaction all run.  Options that only re-lay data or re-time events
(defer_ggx, brick_major, split) are also held bit for bit against the
port's own default render, through the GGX boundary too.
"""

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
from cudavolumerenderer_tpu_torch.config import Config, Kernel
from cudavolumerenderer_tpu_torch.models import fast as tfast
from cudavolumerenderer_tpu_torch.models.renderer import create_renderer
from cudavolumerenderer_tpu_torch.scene import types as ttypes
from cudavolumerenderer_tpu_torch.scene import vol
from cudavolumerenderer_tpu_torch.utils import occupancy as tocc
from cudavolumerenderer_tpu_torch.utils.image import load_hdr
from test_torch_scene_io import write_xml_scene
from test_torch_schedulers import JAX_TOL

torch.set_num_threads(2)

#: 576 lanes in pools of 576, 512 and 256, all of them tail pools (at or
#: under the default tail_width), so the tail options act in every stage;
#: one evaluation per pending-count read keeps JAX's compile short
CASCADE = dict(cascade_factor=2, min_width=256, tail_chain=1)


def scene_pair(d, albedo=None, scale=20.0):
    """JAX scene and its port copy: albedo (d, 0.5, 1 - d), affine in
    density, unless a full per-voxel albedo is given."""
    d = d.astype(np.float32)
    if albedo is None:
        albedo = np.stack([d, 0.5 * np.ones_like(d), 1.0 - d], axis=-1)
    js = jtypes.make_scene(jtypes.make_medium(d, albedo, scale=scale,
                                              max_density=1.0))
    m = js.medium
    ts = convert.scene_from_arrays(
        m.density.data, m.albedo.data, m.albedo_affine, m.box_min,
        m.box_max, m.scale, m.max_density, m.g, js.bsdf.roughness,
        js.bsdf.eta, js.le,
    )
    return ts, js


def medical(shape=(16, 16, 16)):
    return scene_pair(procedural.medical_volume(shape, n_blobs=4))


def render_pair(pair, res=24, spp=4, seed=7, bsdf="null", offsets=None,
                bases=0, eager=False, **kw):
    """with_stats renders of both packages: (img, n_rays, n_rows, n_busy,
    stage rows) as numpy, port first; JAX's op by op with eager."""
    ts, js = pair
    jc = jcam.make_camera(res, res)
    tc = convert.camera_from_arrays(jc.inv_view, jc.raster_to_view)
    tile = (res, res) if offsets is None else (res // 2, res // 2)
    off = np.zeros(2, np.float32) if offsets is None else offsets
    t = tfast.render_tile(
        ts, tc, ttypes.RenderSettings.from_flags(True, bsdf_kind=bsdf),
        tile, torch.from_numpy(off), (res, res), spp, seed,
        torch.as_tensor(np.asarray(bases, np.int64)),
        with_stats=True, **kw)
    with jax.disable_jit(eager):
        j = jfast.render_tile(
            js, jc, jtypes.RenderSettings.from_flags(True, bsdf_kind=bsdf),
            tile, jnp.asarray(off), (res, res), spp, seed,
            jnp.asarray(bases), with_stats=True, **kw)
    return ([np.asarray(x) for x in t], [np.asarray(x) for x in j])


def port_render(ts, res=24, spp=4, seed=7, bsdf="null", **kw):
    jc = jcam.make_camera(res, res)
    tc = convert.camera_from_arrays(jc.inv_view, jc.raster_to_view)
    img, n_rays = tfast.render_tile(
        ts, tc, ttypes.RenderSettings.from_flags(True, bsdf_kind=bsdf),
        (res, res), torch.zeros(2), (res, res), spp, seed, 0, **kw)
    return img.numpy(), float(n_rays)


def assert_matches_jax(t, j):
    """Rays exact, image within JAX_TOL, n_rows and the per-stage rows
    exact.  n_busy (tracking lanes summed over evaluations) within 0.1%:
    a direction a last bit off JAX's (XLA's transcendentals against
    torch's, or under jit an fma XLA contracts, ROADMAP C1) can move a
    brick exit that meets the box's by an ulp, and the lane then tracks
    one evaluation longer without a draw."""
    assert np.isfinite(t[0]).all() and t[1] > 0
    assert t[1] == j[1]
    np.testing.assert_allclose(t[0], j[0], **JAX_TOL)
    assert t[2] == j[2]
    np.testing.assert_array_equal(t[4], j[4])
    assert abs(t[3] - j[3]) <= 1e-3 * j[3]


# -- defer_ggx ---------------------------------------------------------------

@pytest.mark.parametrize("two_level", [False, True], ids=["one", "two"])
@pytest.mark.parametrize("defer", [1, 4])
def test_defer_ggx_matches_jax_and_own_inline_render(defer, two_level):
    """The flush schedule reads n_rows summed over all stages (a host
    copy; with_stats raises if it parts from the device's), so the
    per-stage rows are JAX's; the image and n_rays equal the port's
    defer_ggx=0 render bit for bit, through GGX as well."""
    pair = medical()
    t, j = render_pair(pair, defer_ggx=defer, two_level=two_level, **CASCADE)
    assert len(t[4]) == 3
    assert_matches_jax(t, j)
    for bsdf in ("null", "ggx"):
        a = port_render(pair[0], bsdf=bsdf, defer_ggx=defer,
                        two_level=two_level, **CASCADE)
        b = port_render(pair[0], bsdf=bsdf, two_level=two_level, **CASCADE)
        np.testing.assert_array_equal(a[0], b[0])
        assert a[1] == b[1]


def test_defer_ggx_multi_tile_matches_jax():
    """Multi-tile lane mode (four 12^2 tiles in one cascade) under
    defer_ggx: JAX's stats, and the port's inline render bit for bit."""
    pair = medical()
    offsets = np.array([[0, 0], [12, 0], [0, 12], [12, 12]], np.float32)
    bases = np.arange(4, dtype=np.uint32) * (12 * 12 * 4)
    kw = dict(offsets=offsets, bases=bases, two_level=True, **CASCADE)
    t, j = render_pair(pair, defer_ggx=4, **kw)
    assert t[0].shape == (4, 12, 12, 3)
    assert_matches_jax(t, j)
    inline, _ = render_pair(pair, **kw)
    np.testing.assert_array_equal(t[0], inline[0])
    assert t[1] == inline[1]


def test_pending_lanes_travel_through_compaction(monkeypatch):
    """With a rare flush (every 64 evaluations) the cascade compacts while
    lanes wait for it: pend_b moves with its lane, and the render still
    equals the inline one bit for bit."""
    seen = []
    take = tfast._take_lanes

    def spy(s, idx):
        if isinstance(s, tfast.FastState):
            seen.append(int(s.pend_b[idx].sum()))
        return take(s, idx)

    monkeypatch.setattr(tfast, "_take_lanes", spy)
    ts, _ = medical()
    a = port_render(ts, bsdf="ggx", defer_ggx=64, two_level=True, **CASCADE)
    assert len(seen) == 2 and max(seen) > 0, seen
    b = port_render(ts, bsdf="ggx", two_level=True, **CASCADE)
    np.testing.assert_array_equal(a[0], b[0])
    assert a[1] == b[1]


def test_host_row_count_equals_float32_device_sum():
    """Above 2^24 a float32 sum of widths that are not powers of two
    rounds; the host's numpy float32 copy rounds the same way."""
    widths = [w for w in tfast._cascade_widths(1 << 20, 1.25, 256)
              if w & (w - 1)]
    dev = torch.tensor(float(1 << 24) - 3.0, dtype=torch.float32)
    host = np.float32(dev.item())
    for i in range(5000):
        w = widths[i % len(widths)]
        dev = dev + float(w)
        host = np.float32(host + np.float32(w))
        assert dev.item() == float(host)
    assert float(host) != float(1 << 24) - 3.0 + sum(
        widths[i % len(widths)] for i in range(5000))


# -- tail modes ---------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(tail_spec=4, tail_width=1 << 20, min_width=64),
    dict(tail_single_level=True, tail_spec=8, tail_width=1 << 20,
         min_width=64, tail_chain=4),
], ids=["spec4", "single8"])
def test_white_furnace_exact_tail_modes(kw):
    """tests/test_fast.py's two tail configurations: unit albedo and the
    null boundary give exactly 1.0 whatever the draw schedule."""
    d = procedural.blob_volume()
    ts = ttypes.make_scene(ttypes.make_medium(d, 1.0, scale=40.0,
                                              max_density=1.0, device="cpu"))
    img, _ = port_render(ts, res=16, spp=4, seed=3, two_level=True, **kw)
    np.testing.assert_allclose(img / 4, 1.0, atol=1e-5)


@pytest.mark.parametrize("kw, eager", [
    pytest.param(dict(two_level=True, tail_spec=4), True, id="spec4"),
    pytest.param(dict(two_level=True, tail_single_level=True, tail_spec=8,
                      tail_chain=2), False, id="single8"),
    pytest.param(dict(two_level=True, tail_bricks=2), False, id="bricks2"),
    pytest.param(dict(two_level=True, tail_spec=4, table_bits=4), False,
                 id="spec4-q4"),
    pytest.param(dict(two_level=False, tail_spec=4, spec_width=256), False,
                 id="one-spec4-width256"),
])
def test_tail_modes_match_jax(kw, eager):
    """spec4 is held against JAX op by op: under XLA's CPU jit its last
    stage evaluates one 256-lane pool fewer (n_rows 32,512 against the
    port's and op-by-op JAX's 32,768; ROADMAP, "XLA's CPU jit").  Its rays
    and image are also held against the jitted render."""
    t, j = render_pair(medical(), eager=eager, **{**CASCADE, **kw})
    assert_matches_jax(t, j)
    if eager:
        _, j_jit = render_pair(medical(), **{**CASCADE, **kw})
        assert t[1] == j_jit[1]
        np.testing.assert_allclose(t[0], j_jit[0], **JAX_TOL)


def test_first_stop_takes_the_first_true_and_zero_when_none():
    stopj = torch.tensor([[False, True, True, False],
                          [False, False, False, False],
                          [True, False, False, True],
                          [False, False, False, True]])
    j0, any_stop = tfast.first_stop(stopj)
    assert j0.tolist() == [1, 0, 0, 3]
    assert any_stop.tolist() == [True, False, True, True]
    np.testing.assert_array_equal(
        j0.numpy(), np.asarray(jnp.argmax(jnp.asarray(stopj.numpy()), -1)))


# -- split albedo -------------------------------------------------------------

def full_albedo_pair(shape):
    gen = np.random.default_rng(11)
    d = procedural.medical_volume(shape, n_blobs=4)
    return scene_pair(d, gen.uniform(0.3, 1.0, d.shape + (3,)).astype(
        np.float32))


def test_split_matches_jax_and_full(monkeypatch):
    """A device budget of 40 bytes per voxel sends a full per-voxel albedo
    to 'split' in both packages (the fused copy takes 16 of them, more
    than 30%).  JAX decides the mode when it traces, so its caches are
    cleared and the grid's shape is used by no other test."""
    shape = (18, 20, 22)
    pair = full_albedo_pair(shape)
    budget = 40 * int(np.prod(shape))
    ref = port_render(pair[0], two_level=True, tail_spec=4, **CASCADE)
    assert tfast._albedo_mode(pair[0], allow_split=True) == "full"
    monkeypatch.setattr(tocc, "device_memory_budget", lambda device=None:
                        budget)
    monkeypatch.setattr(jocc, "device_memory_budget", lambda: budget)
    assert tfast._albedo_mode(pair[0], allow_split=True) == "split"
    assert jfast._albedo_mode(pair[1], allow_split=True) == "split"
    jax.clear_caches()
    t, j = render_pair(pair, two_level=True, tail_spec=4, **CASCADE)
    assert_matches_jax(t, j)
    np.testing.assert_array_equal(t[0], ref[0])
    assert t[1] == ref[1]
    one = port_render(pair[0], bsdf="ggx", **CASCADE)
    monkeypatch.undo()
    np.testing.assert_array_equal(
        one[0], port_render(pair[0], bsdf="ggx", **CASCADE)[0])


# -- brick-major layout -------------------------------------------------------

def test_brick_major_table_equals_jax():
    d = np.random.default_rng(3).random((8, 16, 256), dtype=np.float32)
    np.testing.assert_array_equal(
        tfast.brick_major_table(torch.from_numpy(d)).numpy(),
        np.asarray(jfast.brick_major_table(jnp.asarray(d))))


@pytest.mark.parametrize("two_level", [False, True], ids=["one", "two"])
def test_brick_major_matches_jax_and_row_major(two_level):
    """A (16, 16, 128) grid divides the (8, 8, 128) bricks, so the layout
    is used; the image equals the row-major render bit for bit.  JAX runs
    op by op: under its CPU jit one path of this scene's two-level render,
    row-major too, parts at an fma that XLA contracts (ROADMAP C1)."""
    pair = scene_pair(procedural.blob_volume((128, 16, 16), n_blobs=3))
    t, j = render_pair(pair, res=16, brick_major=True, two_level=two_level,
                       eager=True)
    assert_matches_jax(t, j)
    ref = port_render(pair[0], res=16, two_level=two_level)
    np.testing.assert_array_equal(t[0], ref[0])
    assert t[1] == ref[1]


def test_brick_major_falls_back_to_row_major(monkeypatch):
    """As in JAX, brick_major engages only on a flat table whose grid
    divides the bricks: a 16^3 grid, a 'full' table and a 'split' table
    all stay row-major."""
    calls = []
    monkeypatch.setattr(tfast, "brick_major_table",
                        lambda g: calls.append(g.shape))
    scenes = [medical()[0], full_albedo_pair((128, 16, 16))[0]]
    for ts in scenes:
        port_render(ts, res=8, brick_major=True)
    monkeypatch.setattr(tocc, "device_memory_budget",
                        lambda device=None: 40 * 16 * 16 * 128)
    port_render(scenes[1], res=8, brick_major=True)
    assert calls == []


# -- autotune_report and the entry points -------------------------------------

@pytest.mark.parametrize("args", [
    (512 * 512, 4, (256, 256, 256), 80 << 30),
    (64 * 64, 1, (16, 16, 16), 16 << 30),
    (1024 * 1024, 20, (1024, 1024, 1024), 3 << 30),
])
def test_autotune_report_equals_jax(args):
    n_pix, spp, shape, budget = args
    assert tocc.autotune_report(n_pix, spp, shape, budget) == (
        jocc.autotune_report(n_pix, spp, shape, budget))


@pytest.mark.parametrize("option", [
    dict(defer_ggx=2), dict(tail_spec=4), dict(tail_single_level=True),
    dict(tail_spec=4, spec_width=256), dict(tail_bricks=2),
    dict(brick_major=True),
])
def test_create_renderer_renders_each_option(option):
    """Config carries every option to fastSK (spec_width included); the
    renderer's image is render_tile's."""
    ts, _ = scene_pair(procedural.blob_volume((128, 16, 16), n_blobs=3))
    jc = jcam.make_camera(24, 24)
    tc = convert.camera_from_arrays(jc.inv_view, jc.raster_to_view)
    cfg = Config(kernel=Kernel.FAST_SK, resolution=(24, 24), iterations=4,
                 seed=7, two_level=True, cascade_factor=2, min_width=256,
                 **option)
    img = create_renderer(ts, tc, cfg).render()
    assert np.isfinite(img).all() and img.mean() > 0
    want, _ = port_render(ts, bsdf=cfg.settings.bsdf_kind, two_level=True,
                          cascade_factor=2, min_width=256, **option)
    np.testing.assert_allclose(img, want / 4, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("extra", [
    ["--tail-single-level", "--tail-spec", "4"],
    ["--tail-spec", "2", "--spec-width", "256"],
    ["--tail-bricks", "2"],
], ids=["single-level", "spec-width", "tail-bricks"])
def test_cli_renders_each_tail_option(tmp_path, extra):
    """The tail options reach fastSK through the CLI (16^2 x 2 in pools
    of 512 and 256 lanes, two-level) and render finite images."""
    scene = write_xml_scene(tmp_path)
    out = str(tmp_path / "t")
    assert cli.main([scene, "-i", "2", "-r", "16", "16", "--two-level",
                     "--lanes-per-pixel", "2", "--min-width", "256",
                     "--platform", "cpu", "-o", out, *extra]) == 0
    img = load_hdr(out + ".hdr")
    assert img.shape == (16, 16, 3) and np.isfinite(img).all()
    assert img.mean() > 0


def test_cli_renders_split_planned_scene(tmp_path, monkeypatch):
    """An XML scene with a per-voxel albedo that is not affine in density,
    planned 'split' under a small budget, renders through the CLI as it
    does 'full'."""
    scene = write_xml_scene(tmp_path)
    d = np.random.default_rng(5).uniform(0.3, 1.0, (8, 16, 16, 3))
    vol.write_vol(str(tmp_path / "albedo.vol"), d.astype(np.float32),
                  (-0.5, -0.5, -0.5), (0.5, 0.5, 0.5))
    argv = [scene, "-i", "2", "-r", "16", "16", "--two-level",
            "--platform", "cpu"]
    assert cli.main(argv + ["-o", str(tmp_path / "full")]) == 0
    monkeypatch.setattr(tocc, "device_memory_budget",
                        lambda device=None: 40 * 16 * 16 * 8)
    assert cli.main(argv + ["-o", str(tmp_path / "split")]) == 0
    a = load_hdr(str(tmp_path / "split.hdr"))
    assert np.isfinite(a).all() and a.mean() > 0
    np.testing.assert_array_equal(a, load_hdr(str(tmp_path / "full.hdr")))
