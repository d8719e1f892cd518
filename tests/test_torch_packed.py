"""fastSK's packed quantized density tables (table_bits 8 and 4) in the
port, against the JAX package (models/fast.py:495-570).

- The packed words and the dequantized grid equal a numpy transcription
  of JAX fast.py:503-545 (uint32 words, strided by 128 rows, padded to a
  multiple of 128 * 2 * per voxels); every word and every tap agree.
- The port's render_tile with table_bits 8 and 4 gives JAX's ray count
  exactly and its image within the scheduler tests' JAX_TOL, one- and
  two-level, on the scenes of tests/test_fast.py's two packed-table
  tests at their seed 7, with the null boundary; through the GGX
  boundary, within the bound the f32 table keeps there.
- On a density that lies on the 255-level grid, table_bits 8 renders
  bit-identically to the f32 table (tests/test_fast.py:332's analog), and
  the majorants, built from the dequantized grid, bound every tap.
- baseline_configs --champion builds the JAX script's Config fields.
"""

import importlib.util
import os
import types as pytypes

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cudavolumerenderer_tpu import cli as jcli
from cudavolumerenderer_tpu.models import fast as jfast
from cudavolumerenderer_tpu.ops import camera as jcam
from cudavolumerenderer_tpu.scene import procedural
from cudavolumerenderer_tpu.scene import types as jtypes
from cudavolumerenderer_tpu_torch import cli, convert
from cudavolumerenderer_tpu_torch.benchmarks import baseline_configs as bc
from cudavolumerenderer_tpu_torch.models import fast as tfast
from cudavolumerenderer_tpu_torch.scene import types as ttypes
from cudavolumerenderer_tpu_torch.utils.image import load_hdr
from test_torch_cli import plain
from test_torch_scene_io import write_xml_scene
from test_torch_schedulers import JAX_TOL

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# -- a numpy transcription of JAX fast.py:503-545 ---------------------------

def np_quantize(g, maxd, bits):
    qmax = np.float32((1 << bits) - 1)
    return np.round(np.clip(g / np.float32(maxd), 0.0, 1.0) * qmax)


def np_pack(flat, maxd, bits):
    """JAX's packed words, uint32, flattened (its (Vp, 2) pairs and its
    flat layout hold the same words in the same order)."""
    per = 32 // bits
    q_flat = np_quantize(flat, maxd, bits).astype(np.uint32)
    pad = (-q_flat.size) % (128 * 2 * per)
    q2 = np.pad(q_flat, (0, pad)).reshape(-1, 128)
    word2 = np.zeros((q2.shape[0] // per, 128), np.uint32)
    for k in range(per):
        word2 = word2 | (q2[k::per, :] << np.uint32(k * bits))
    return word2.reshape(-1)


def np_dequant_grid(g, maxd, bits):
    dequant = np.float32(maxd) / np.float32((1 << bits) - 1)
    return (np_quantize(g, maxd, bits) * dequant).astype(np.float32)


def np_take(words, j, maxd, bits):
    per = 32 // bits
    r, c = j >> 7, j & 127
    word = words[(r // per) * 128 + c]
    shift = (r % per).astype(np.uint32) * np.uint32(bits)
    valq = (word >> shift) & np.uint32((1 << bits) - 1)
    dequant = np.float32(maxd) / np.float32((1 << bits) - 1)
    return valq.astype(np.float32) * dequant


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("shape, maxd", [((17, 19, 23), 1.0),
                                         ((16, 16, 16), 0.8),
                                         ((3, 5, 7), 2.5)])
def test_words_and_dequant_equal_jax_transcription(shape, maxd, bits):
    """17x19x23 and 3x5x7 voxels are no multiple of 128 * 2 * per, so the
    table is padded; values above max_density and below 0 clip."""
    gen = np.random.default_rng(sum(shape) + bits)
    g = (gen.random(shape, dtype=np.float32) * 1.2 * maxd - 0.1).astype(np.float32)
    flat = g.reshape(-1)
    maxd_t = torch.tensor(maxd, dtype=torch.float32)
    words = tfast.pack_density(torch.from_numpy(flat), maxd_t, bits)
    want = np_pack(flat, maxd, bits)
    assert words.dtype == torch.int32
    per = 32 // bits
    assert words.numel() == want.size == -(-flat.size // (256 * per)) * 256
    np.testing.assert_array_equal(words.numpy().view(np.uint32), want)
    deq = tfast.dequant_grid(torch.from_numpy(g), maxd_t, bits).numpy()
    np.testing.assert_array_equal(deq, np_dequant_grid(g, maxd, bits))
    j = np.arange(flat.size)
    taps = tfast.packed_take(words, torch.from_numpy(j), maxd_t, bits).numpy()
    np.testing.assert_array_equal(taps, np_take(want, j, maxd, bits))
    np.testing.assert_array_equal(taps, deq.reshape(-1))
    # the padding holds level 0
    pad = np.arange(flat.size, words.numel() * per)
    np.testing.assert_array_equal(np_take(want, pad, maxd, bits), 0.0)


# -- renders against JAX ----------------------------------------------------

def scene_pair(d, maxd, scale=20.0):
    """tests/test_fast.py's packed-table scene: affine albedo
    (d, 0.5, 1 - d), built by JAX and carried across with convert."""
    alb = np.stack([d, 0.5 * np.ones_like(d), 1.0 - d], axis=-1)
    js = jtypes.make_scene(jtypes.make_medium(
        d.astype(np.float32), alb, scale=scale, max_density=maxd))
    m = js.medium
    ts = convert.scene_from_arrays(
        m.density.data, m.albedo.data, m.albedo_affine, m.box_min,
        m.box_max, m.scale, m.max_density, m.g, js.bsdf.roughness,
        js.bsdf.eta, js.le,
    )
    return ts, js


def quantized_scene():
    """tests/test_fast.py:378-383: a medical volume not on the level grid."""
    return scene_pair(procedural.medical_volume((16, 16, 16), n_blobs=4), 1.0)


def representable_scene():
    """tests/test_fast.py:346-356: density k/256 with max_density 255/256,
    so the dequant scale is exactly 1/256 and every level round-trips."""
    d = np.round(procedural.medical_volume((16, 16, 16), n_blobs=4) * 255) / 256
    return scene_pair(d, 255.0 / 256.0)


def render_pair(scene_of, bsdf, **kw):
    """(port image, rays), (JAX image, rays) at 16^2 x 4, seed 7."""
    ts, js = scene_of()
    jc = jcam.make_camera(16, 16)
    tc = convert.camera_from_arrays(jc.inv_view, jc.raster_to_view)
    t_img, t_rays = tfast.render_tile(
        ts, tc, ttypes.RenderSettings.from_flags(True, bsdf_kind=bsdf),
        (16, 16), torch.zeros(2), (16, 16), 4, 7, 0, **kw)
    j_img, j_rays = jfast.render_tile(
        js, jc, jtypes.RenderSettings.from_flags(True, bsdf_kind=bsdf),
        (16, 16), jnp.zeros(2, jnp.float32), (16, 16), 4, 7, 0, **kw)
    return (t_img.numpy(), float(t_rays)), (np.asarray(j_img), float(j_rays))


@pytest.mark.parametrize("two_level", [False, True], ids=["one", "two"])
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("scene_of", [quantized_scene, representable_scene])
def test_packed_render_matches_jax(scene_of, bits, two_level):
    """With the null boundary the f32 table gives JAX's render on these
    scenes, so the packed taps are held to the same: ray counts exact,
    images within JAX_TOL."""
    (a, na), (b, nb) = render_pair(scene_of, "null", two_level=two_level,
                                   table_bits=bits)
    assert np.isfinite(a).all() and na > 0
    assert na == nb
    np.testing.assert_allclose(a, b, **JAX_TOL)


@pytest.mark.parametrize("bits", [32, 8, 4])
def test_packed_render_with_ggx_agrees_with_jax(bits):
    """Through the GGX boundary the port and JAX part on a path or two
    even with the f32 table (one pixel of 256 here; the last bits of
    XLA's transcendentals, ROADMAP C): packed tables keep that bound, as
    the multi-tile tests state it."""
    (a, na), (b, nb) = render_pair(quantized_scene, "ggx", two_level=True,
                                   table_bits=bits)
    assert abs(na - nb) <= 0.01 * nb
    share = float(np.mean(np.all(np.isclose(a, b, **JAX_TOL), axis=-1)))
    assert share >= 0.99, share


@pytest.mark.parametrize("bits", [32, 4])
def test_packed_render_with_ggx_equals_jax_op_by_op(bits):
    """The parting above is XLA's CPU jit, not the port: op by op
    (jax.disable_jit) JAX renders the port's image and ray count bit for
    bit.  Under jit XLA contracts a * b + c into an fma and rewrites
    1 / sqrt(x) as rsqrt; the first to move a path here is the entry
    point o + d * dist (models/fast.py's o_bound), 0.49999857 against
    0.5 on the box's z face (ROADMAP C1)."""
    with jax.disable_jit():
        (a, na), (b, nb) = render_pair(quantized_scene, "ggx",
                                       two_level=True, table_bits=bits)
    assert na == nb
    np.testing.assert_array_equal(a, b)


def test_packed_render_differs_from_f32():
    """The quantized scene is not on the level grid: 4 bits moves the
    render (so the tests above exercise the packed taps)."""
    (a, _), _ = render_pair(quantized_scene, "null", two_level=True)
    (b, _), _ = render_pair(quantized_scene, "null", two_level=True,
                            table_bits=4)
    assert not np.array_equal(a, b)


def port_render(ts, seed, **kw):
    tc = convert.camera_from_arrays(*(lambda c: (c.inv_view, c.raster_to_view))(
        jcam.make_camera(16, 16)))
    return tfast.render_tile(
        ts, tc, ttypes.RenderSettings.from_flags(True), (16, 16),
        torch.zeros(2), (16, 16), 4, seed, 0, **kw)


@pytest.mark.parametrize("two_level", [False, True], ids=["one", "two"])
def test_packed_table_exact_when_representable(two_level):
    ts, _ = representable_scene()
    a, na = port_render(ts, 7, two_level=two_level)
    b, nb = port_render(ts, 7, two_level=two_level, table_bits=8)
    assert torch.equal(a, b) and float(na) == float(nb)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("scene_of", [quantized_scene, representable_scene])
def test_majorants_bound_every_tap(scene_of, bits):
    """Every brick's majorant, built from the dequantized grid, bounds the
    packed value of every voxel a tap from inside the brick can reach
    (the brick and a one-voxel border on the high side)."""
    ts, _ = scene_of()
    med = ts.medium
    d = med.density.data
    words = tfast.pack_density(d.reshape(-1), med.max_density, bits)
    taps = tfast.packed_take(words, torch.arange(d.numel()), med.max_density,
                             bits).reshape(d.shape)
    brick = tfast.pick_brick(d.shape)
    major = tfast.brick_majorants(
        tfast.dequant_grid(d, med.max_density, bits), brick)
    bz, by, bx = brick
    for iz, iy, ix in np.ndindex(*major.shape):
        window = taps[iz * bz:(iz + 1) * bz + 1, iy * by:(iy + 1) * by + 1,
                      ix * bx:(ix + 1) * bx + 1]
        assert float(window.max()) <= float(major[iz, iy, ix])
    # the f32 grid's majorant does not always bound the rounded-up taps
    loose = tfast.brick_majorants(d, brick)
    if scene_of is quantized_scene:
        assert bool((loose < major).any())


# -- baseline_configs --champion --------------------------------------------

def fake_result():
    return {"mrays_per_sec": 1.0, "mean_time": 1.0,
            "mean_time_with_copy": 1.0, "n_rays": 1.0}


def port_champion_configs(tmp_path, monkeypatch):
    seen = []
    monkeypatch.setattr(cli, "run_test",
                        lambda config, device: seen.append(config) or fake_result())
    for name in ("write_bucky", "write_medical_mhd", "write_hetvol_vdb",
                 "write_mitsuba_xml"):
        monkeypatch.setattr(bc, name, lambda tmp, n=name: os.path.join(tmp, n))
    assert bc.main(["--platform", "cpu", "--champion", "--trials", "1",
                    "--workdir", str(tmp_path)]) == 0
    return seen


def jax_champion_configs(tmp_path, monkeypatch):
    spec = importlib.util.spec_from_file_location(
        "jax_baseline_configs",
        os.path.join(ROOT, "benchmarks", "baseline_configs.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    seen = []
    monkeypatch.setattr(jcli, "run_test",
                        lambda config: seen.append(config) or fake_result())
    for name in ("bucky", "medical_mhd", "hetvol_vdb", "mitsuba_xml"):
        monkeypatch.setattr(mod, f"_write_{name}",
                            lambda tmp, n=name: os.path.join(tmp, f"write_{n}"))
    # the script makes its scene directory under /tmp; nothing is written
    monkeypatch.setattr(mod, "os", pytypes.SimpleNamespace(
        path=os.path, makedirs=lambda *a, **k: None))
    monkeypatch.setattr("sys.argv", [
        "baseline_configs.py", "--champion", "--trials", "1",
        "--out", str(tmp_path / "jax.json")])
    assert mod.main() == 0
    return seen


def test_champion_builds_jax_config_fields(tmp_path, monkeypatch):
    ours = port_champion_configs(tmp_path, monkeypatch)
    theirs = jax_champion_configs(tmp_path, monkeypatch)
    assert len(ours) == len(theirs) == 4
    for t, j in zip(ours, theirs):
        fields = [f for f in vars(t) if f != "settings"]
        assert {"table_bits", "allow_quantized", "min_width",
                "max_bricks", "cascade_factor"} <= set(fields)
        for name in fields:
            a, b = plain(getattr(t, name)), plain(getattr(j, name))
            if name in ("scene_file", "output_name"):
                a, b = os.path.basename(a), os.path.basename(b)
            assert a == b, name
        for name in vars(t.settings):
            assert getattr(t.settings, name) == getattr(j.settings, name), name
        assert t.effective_table_bits == j.effective_table_bits == 4
    medical = [t for t in ours if t.output_name.endswith("2_medical_mhd_512")]
    assert medical and medical[0].max_bricks == 512
    assert medical[0].cascade_factor == 1.25


@pytest.mark.parametrize("bits", ["8", "4"])
def test_cli_renders_packed_tables(tmp_path, monkeypatch, bits):
    """--table-bits with --allow-quantized reaches fast.render_tile through
    the CLI's batch mode and renders."""
    scene = write_xml_scene(tmp_path)
    out = str(tmp_path / "q")
    seen = []
    orig = tfast.render_tile

    def counted(*args, **kw):
        seen.append(kw.get("table_bits"))
        return orig(*args, **kw)

    monkeypatch.setattr(tfast, "render_tile", counted)
    assert cli.main([scene, "-i", "1", "-r", "8", "8", "--two-level",
                     "--table-bits", bits, "--allow-quantized", "-o", out,
                     "--platform", "cpu"]) == 0
    assert seen and set(seen) == {int(bits)}
    img = load_hdr(out + ".hdr")
    assert img.shape == (8, 8, 3) and np.isfinite(img).all()
