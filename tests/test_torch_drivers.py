"""The port's measurement drivers (cudavolumerenderer_tpu_torch/benchmarks:
run_suite and the micro_* scripts) against the JAX package's scripts of
the same names (benchmarks/), on the CPU at a tiny size.

For each driver:
  * its scene, made from the same seed, equals the JAX script's bit for bit
    (density, albedo, scale, majorant) and so does albedo_affine, the fit
    that gates the tail kernel;
  * one row through the port equals the JAX function the script calls on
    the same inputs, seed and options: the row's call is recorded and
    replayed through JAX (fast.render_tile, create_renderer(...).render(),
    regeneration.render_tile, brick.render_tile), with the tolerance of that
    scheduler's own test, stated at each comparison;
  * main([..., "--platform", "cpu"]) returns every key the JAX script
    writes (read from its text), and the sweeps are the scripts' sweeps row
    for row (names and keywords, evaluated from the scripts' list
    literals).

The sizes shrink through scene_classes.CLASSES and the drivers' module
constants (grids of 6^3-12^3, 8^2 pixels, 1 spp, one timed rep).
"""

import ast
import dataclasses
import inspect
import json
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cudavolumerenderer_tpu.config import Config as JConfig
from cudavolumerenderer_tpu.config import Kernel as JKernel
from cudavolumerenderer_tpu.models import brick as jbrick
from cudavolumerenderer_tpu.models import fast as jfast
from cudavolumerenderer_tpu.models import regeneration as jregen
from cudavolumerenderer_tpu.models.renderer import create_renderer as jcreate
from cudavolumerenderer_tpu.ops import camera as jcam
from cudavolumerenderer_tpu.scene import procedural as jproc
from cudavolumerenderer_tpu.scene import types as jtypes
from cudavolumerenderer_tpu.scene import vdb as jvdb
from cudavolumerenderer_tpu.scene.raw_builder import (
    albedo_from_density as j_albedo_from_density,
)
from cudavolumerenderer_tpu_torch.benchmarks import (
    baseline_configs,
    micro_ablate,
    micro_bucky_r5,
    micro_classes,
    micro_config3,
    micro_driver_overhead,
    micro_medical,
    micro_medical2,
    micro_smoke2,
    micro_smoke_brick,
    micro_stats,
    run_suite,
)
from cudavolumerenderer_tpu_torch.benchmarks import scene_classes as sc
from cudavolumerenderer_tpu_torch.models import brick as tbrick
from cudavolumerenderer_tpu_torch.models import fast as tfast
from cudavolumerenderer_tpu_torch.models import regeneration as tregen
from cudavolumerenderer_tpu_torch.scene import procedural as tproc
from cudavolumerenderer_tpu_torch.scene import vdb as tvdb

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
#: the family's and brickSK's images agree with JAX to XLA's last bits
#: (tests/test_torch_schedulers.py, tests/test_torch_brick.py)
JAX_TOL = dict(rtol=1e-4, atol=1e-4)
#: tiny sizes: grid (x, y, z), resolution, iterations
TINY = {"bucky": ((6, 6, 6), 8, 1), "smoke": ((12, 12, 6), 8, 1),
        "medical": ((8, 8, 8), 8, 1), "medical_blobs": ((8, 8, 8), 8, 1)}


@pytest.fixture(autouse=True)
def tiny(monkeypatch):
    monkeypatch.setattr(sc, "CLASSES", dict(TINY))
    monkeypatch.setattr(run_suite, "TILING", (16, 1, (1, 2)))
    monkeypatch.setattr(micro_classes, "REPS", 1)
    monkeypatch.setattr(micro_medical, "REPS", 1)
    monkeypatch.setattr(micro_ablate, "REGEN_REPS", 2)
    monkeypatch.setattr(micro_ablate, "REGEN_LANES", 32)


# -- the JAX scripts' scenes ----------------------------------------------------

def jax_arrays(name, grid):
    """The JAX scripts' recipe (benchmarks/run_suite.py:52-71; medical_blobs
    is micro_ablate.py:75-77's): (density, albedo, scale, max_density)."""
    if name == "bucky":
        d = jproc.blob_volume(grid)
        return d, j_albedo_from_density(d), 40.0, 1.0
    if name == "smoke":
        d = jproc.smoke_volume(grid)
        return d, np.stack([d, d, d], axis=-1) * 0.9, 800.0, float(d.max())
    if name == "medical_blobs":
        d = jproc.blob_volume(grid, n_blobs=40)
    else:
        d = jproc.medical_volume(grid, n_blobs=40)
    return d, np.stack([d, 0.5 * np.ones_like(d), 1.0 - d], axis=-1), \
        100.0, 1.0


def jax_scene(name):
    d, alb, scale, md = jax_arrays(name, TINY[name][0])
    return jtypes.make_scene(jtypes.make_medium(d, alb, scale=scale,
                                                max_density=md))


def assert_same_scene(ts, js):
    """Every array of the medium bit for bit, albedo_affine included."""
    tm, jm = ts.medium, js.medium
    for t, j in ((tm.density.data, jm.density.data),
                 (tm.albedo.data, jm.albedo.data), (tm.scale, jm.scale),
                 (tm.max_density, jm.max_density), (tm.box_min, jm.box_min),
                 (tm.box_max, jm.box_max), (tm.g, jm.g),
                 (ts.bsdf.roughness, js.bsdf.roughness),
                 (ts.bsdf.eta, js.bsdf.eta), (ts.le, js.le)):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    assert (tm.albedo_affine is None) == (jm.albedo_affine is None)
    if jm.albedo_affine is not None:
        np.testing.assert_array_equal(tm.albedo_affine.numpy(),
                                      np.asarray(jm.albedo_affine))


@pytest.mark.parametrize("name", list(TINY))
def test_scene_classes_equal_the_jax_scripts_scenes(name):
    """The shared classes at a tiny grid, and albedo_affine as JAX detects
    it: the medical classes' (d, 0.5, 1 - d) is affine, the bucky class's
    transfer function is not."""
    ts, js = sc.scene(name, CPU), jax_scene(name)
    assert_same_scene(ts, js)
    assert (ts.medium.albedo_affine is not None) == (name != "bucky")


def test_procedural_keeps_the_blob_field_and_returns_copies():
    """The kept blob field is never handed out: a caller that writes its
    grid changes no later grid, and the grids stay JAX's bit for bit
    (a list resolution too)."""
    first = tproc.blob_volume((8, 8, 8), n_blobs=40)
    first[:] = -1.0
    again = tproc.blob_volume([8, 8, 8], n_blobs=40)
    assert again.flags.writeable
    np.testing.assert_array_equal(again, jproc.blob_volume((8, 8, 8),
                                                           n_blobs=40))
    np.testing.assert_array_equal(tproc.medical_volume([8, 8, 8]),
                                  jproc.medical_volume((8, 8, 8)))


# -- replaying a row's call through JAX -----------------------------------------

class Recorder:
    """Wraps module.name; keeps each call's bound arguments and result."""

    def __init__(self, monkeypatch, module, name):
        self.calls = []
        real = getattr(module, name)
        sig = inspect.signature(real)

        def recorded(*a, **kw):
            out = real(*a, **kw)
            bound = sig.bind(*a, **kw)
            self.calls.append((dict(bound.arguments), out))
            return out

        monkeypatch.setattr(module, name, recorded)


def jax_settings(s):
    return jtypes.RenderSettings(**dataclasses.asdict(s))


def replay(call, jmodule, js, **extra):
    """The recorded render_tile call through JAX's function of the same
    name, on the JAX scene js: (port img, port n_rays, JAX outputs)."""
    args, out = call
    res = args["full_resolution"]
    jargs = dict(args, scene=js, camera=jcam.make_camera(*res),
                 settings=jax_settings(args["settings"]),
                 tile_offset=jnp.asarray(np.asarray(args["tile_offset"])))
    jout = jmodule.render_tile(**jargs, **extra)
    return out, jout


def c1_allowance(t_img, t_rays, j_img, j_rays):
    """fastSK against jitted JAX with the GGX boundary (the tolerance of
    tests/test_torch_packed.py, ROADMAP C1: XLA's CPU jit contracts fmas
    and rewrites 1 / sqrt, which moves a path or two): n_rays within 1%,
    99% of the pixels within JAX_TOL; each image finite."""
    a, b = np.asarray(t_img), np.asarray(j_img)
    assert np.isfinite(a).all() and a.shape == b.shape
    assert abs(float(t_rays) - float(j_rays)) <= 0.01 * float(j_rays)
    share = float(np.mean(np.all(np.isclose(a, b, **JAX_TOL), axis=-1)))
    assert share >= 0.99, share


def family_exact(t_img, t_rays, j_img, j_rays):
    """The family's and brickSK's tolerance (tests/test_torch_schedulers.py,
    tests/test_torch_brick.py): n_rays exactly, images within JAX_TOL."""
    assert float(t_rays) == float(j_rays)
    np.testing.assert_allclose(np.asarray(t_img), np.asarray(j_img),
                               **JAX_TOL)


def check_fast_call(call, name, **extra):
    (img, nr, *_), jout = replay(call, jfast, jax_scene(name), **extra)
    c1_allowance(img, nr, jout[0], jout[1])
    return jout


# -- each driver's main: its keys, and one row against JAX -----------------------

def jax_text(name):
    return (ROOT / "benchmarks" / f"{name}.py").read_text()


def json_keys(text):
    """The keys the JAX script writes: dict-literal keys and d["key"] = ."""
    return (set(re.findall(r'(?<!== )"(\w+)":', text))
            | set(re.findall(r"\bd\[\"(\w+)\"\] =", text)))


def returned_keys(d):
    keys = set()
    for k, v in d.items():
        keys.add(k)
        if isinstance(v, dict):
            keys |= returned_keys(v)
    return keys


def run_main(mod, argv, tmp_path, jax_name, mode=""):
    """main on the CPU, writing --out: the file holds the returned dict, and
    that dict the driver's KEYS of its `mode`, which cover every key of the
    JAX script's JSON."""
    out = tmp_path / "out.json"
    res = mod.main(["--platform", "cpu", *argv, "--out", str(out)])
    assert json.loads(out.read_text()) == json.loads(json.dumps(res))
    script = json_keys(jax_text(jax_name))
    assert script and script <= set().union(*mod.KEYS.values()), \
        script - set().union(*mod.KEYS.values())
    assert mod.KEYS[mode] <= returned_keys(res), \
        mod.KEYS[mode] - returned_keys(res)
    return res


def test_run_suite_matches_jax(monkeypatch, tmp_path):
    """main --quick: every row's keys; the naiveSK row (n_lanes 2^17,
    through create_renderer) against JAX's create_renderer (the family's
    tolerance) and the direct fastSK-2L row's timed call (seed 1300, C1);
    main --tiling: the 2x2 row, whose four 8x8 tiles render in one batched
    cascade, against JAX's create_renderer (C1)."""
    made = Recorder(monkeypatch, run_suite, "create_renderer")
    rec = Recorder(monkeypatch, tfast, "render_tile")
    res = run_main(run_suite, ["--quick", "--kernels", "naiveSK", "fastSK"],
                   tmp_path, "run_suite")
    assert set(res) == {f"{s}/{k}" for s in ("bucky32", "smoke128")
                        for k in ("naiveSK", "fastSK", "fastSK-2L")}
    assert all(r["eager"] > 0 and r["n_rays"] > 0 and r["fastbody"] == 0
               for r in res.values())
    assert {k: r["kernels"] for k, r in res.items() if "bucky" in k} == {
        "bucky32/naiveSK": ["familybody"], "bucky32/fastSK": ["fastbody"],
        "bucky32/fastSK-2L": ["fastbody"]}
    renderer = made.calls[0][1]
    assert renderer.config.kernel.value == "naiveSK"
    r, spp = sc.size("bucky")
    jr = jcreate(jax_scene("bucky"), jcam.make_camera(r, r), JConfig(
        kernel=JKernel.NAIVE_SK, iterations=spp, resolution=(r, r),
        n_lanes=1 << 17, settings=jtypes.RenderSettings.from_flags(True)))
    j_img = jr.render()
    family_exact(renderer.get_image(), res["bucky32/naiveSK"]["n_rays"],
                 j_img, jr.n_rays)
    call = rec.calls[-1]
    assert call[0]["seed"] == 1300 and call[0]["spp"] == sc.size("smoke")[1]
    check_fast_call(call, "smoke")

    tiles = run_main(run_suite, ["--tiling"], tmp_path, "run_suite",
                     mode="--tiling")
    assert list(tiles) == [f"tiling1920/fastSK-2L/{n}x{n}" for n in (1, 2)]
    row = tiles["tiling1920/fastSK-2L/2x2"]
    assert row["tiles_path"] == "batched" and row["paths_per_tile"] == 64
    jr = jcreate(jax_scene("bucky"), jcam.make_camera(16, 16), JConfig(
        kernel=JKernel.FAST_SK, iterations=1, resolution=(16, 16),
        n_tiles=(2, 2), two_level=True,
        settings=jtypes.RenderSettings.from_flags(True)))
    c1_allowance(made.calls[-1][1].get_image(), row["n_rays"], jr.render(),
                 jr.n_rays)


def test_micro_classes_matches_jax(monkeypatch):
    """main on the medical class: its labels and albedo_affine (the JAX
    script prints them); the cascade_factor 2 row's timed call (C1)."""
    rec = Recorder(monkeypatch, tfast, "render_tile")
    out = micro_classes.main(["--platform", "cpu", "medical"])
    assert set(out) == {"medical"} and out["medical"]["albedo_affine"] is True
    assert set(out["medical"]) == micro_classes.KEYS[""]
    assert '("casc=4", dict())' in jax_text("micro_classes")
    call = rec.calls[-1]
    assert call[0]["cascade_factor"] == 2 and call[0]["seed"] == 702
    check_fast_call(call, "medical")


def test_micro_stats_matches_jax(monkeypatch):
    """main (two of the classes) at both levels, with the quantities the
    JAX script prints; the bucky one-level row's timed call (C1), its rows
    within 1%."""
    rec = Recorder(monkeypatch, tfast, "render_tile")
    monkeypatch.setattr(micro_stats, "NAMES", ("bucky", "smoke"))
    out = micro_stats.main(["--platform", "cpu"])
    assert set(out) == {f"{n} 2L={i}" for n in ("bucky", "smoke")
                        for i in (0, 1)}
    assert micro_stats.KEYS[""] <= set(out["bucky 2L=0"])
    call = [c for c in rec.calls if c[0]["seed"] == 99][0]
    assert call[0]["two_level"] is False and call[0]["with_stats"] is True
    jout = check_fast_call(call, "bucky")
    rows = out["bucky 2L=0"]["rows"]
    assert abs(rows - float(jout[2])) <= 0.01 * float(jout[2])


def test_micro_ablate_matches_jax(monkeypatch):
    """main: the four rows on the JAX script's scene (the blob field, not
    the medical class) and their keys; GGX with RR off, the row whose drain
    waits on its longest lane, against JAX (C1); main --regen-levels:
    refill groups 1, 8 and 1,024, and group 8's timed call (the family's
    tolerance)."""
    rec = Recorder(monkeypatch, tfast, "render_tile")
    out = micro_ablate.main(["--platform", "cpu"])
    assert list(out) == [f"bsdf={b} rr={rr}" for b in ("ggx", "null")
                         for rr in (1, 0)]
    assert micro_ablate.KEYS[""] <= returned_keys(out)
    row = out["bsdf=ggx rr=0"]
    assert row["longest_lane"] is None and row["eager"] > 0
    assert row["kernels"] == ["fastbody"]
    call = rec.calls[3]
    assert call[0]["seed"] == 77
    assert call[0]["settings"].russian_roulette is False
    assert_same_scene(call[0]["scene"], jax_scene("medical_blobs"))
    check_fast_call(call, "medical_blobs")

    rec = Recorder(monkeypatch, tregen, "render_tile")
    out = micro_ablate.main(["--platform", "cpu", "--regen-levels"])
    assert list(out) == [f"refill_group={g}" for g in (1, 8, 1024)]
    assert micro_ablate.KEYS["--regen-levels"] <= returned_keys(out)
    assert all(r["familybody"] == 0 and r["eager"] > 0 for r in out.values())
    call = [c for c in rec.calls if c[0]["refill_group"] == 8][-1]
    assert call[0]["n_lanes"] == 32
    (img, nr), jout = replay(call, jregen, jax_scene("bucky"))
    family_exact(img, nr, jout[0], jout[1])


def test_micro_driver_overhead_matches_jax(monkeypatch):
    """main: the four paths' keys and reps; the direct path's last call
    (C1) and the driver path's image (create_renderer, C1) against JAX."""
    rec = Recorder(monkeypatch, tfast, "render_tile")
    made = Recorder(monkeypatch, micro_driver_overhead, "create_renderer")
    out = micro_driver_overhead.main(["--platform", "cpu"])
    assert set(out) == micro_driver_overhead.KEYS[""]
    assert [len(out[k]["times_s"]) for k in list(out)[1:]] == [3, 2, 3, 2]
    direct = [c for c in rec.calls if c[0]["seed"] == 11]
    assert len(direct) == 1
    check_fast_call(direct[0], "bucky")
    renderer = made.calls[0][1]
    r, spp = sc.size("bucky")
    jr = jcreate(jax_scene("bucky"), jcam.make_camera(r, r), JConfig(
        kernel=JKernel.FAST_SK, iterations=spp, resolution=(r, r),
        n_tiles=(1, 1), n_lanes=1 << 17, two_level=True,
        seed=renderer.config.seed,
        settings=jtypes.RenderSettings.from_flags(True)))
    c1_allowance(renderer.get_image(), renderer.n_rays, jr.render(),
                 jr.n_rays)


def test_micro_medical_matches_jax(monkeypatch):
    """main at m = 2: its keys; the timed call (C1)."""
    rec = Recorder(monkeypatch, tfast, "render_tile")
    out = micro_medical.main(["--platform", "cpu", "2"])
    assert set(out) == {"albedo_affine", "m=2"} and out["albedo_affine"]
    assert set(out) <= micro_medical.KEYS[""]
    assert rec.calls[-1][0]["lanes_per_pixel"] == 2
    check_fast_call(rec.calls[-1], "medical")


def test_micro_medical2_matches_jax(monkeypatch, tmp_path):
    """main --only q4+m2 tailpk128s32: the JAX script's keys, the tail
    kernel's row at 32 steps run through the tail stage; the q4 row with
    m = 2 against JAX (C1).  (The tail stage against JAX's Pallas kernel is
    tests/test_torch_render.py's and tests/test_torch_taildrain.py's.)"""
    rec = Recorder(monkeypatch, tfast, "render_tile")
    res = run_main(micro_medical2, ["--res", "8", "--spp", "1", "--reps",
                                    "1", "--no-stats", "--only", "q4+m2",
                                    "tailpk128s32"], tmp_path,
                   "micro_medical2")
    assert list(res) == ["b16+tailpk128s32", "b8+minw128+q4+m2"]
    assert res["b8+minw128+q4+m2"]["precision"] == "reduced-q4"
    assert res["b16+tailpk128s32"]["eager"] > 0
    assert res["b16+tailpk128s32"]["kernels"] == ["fastbody", "taildrain"]
    assert res["b8+minw128+q4+m2"]["kernels"] == ["fastbody"]
    tail, q4 = rec.calls[1], rec.calls[-1]
    assert tail[0]["tail_pallas"] and tail[0]["tail_pk_steps"] == 32
    assert q4[0]["table_bits"] == 4 and q4[0]["lanes_per_pixel"] == 2
    check_fast_call(q4, "medical")


@pytest.mark.parametrize("row", ["casc2+b2", "casc2+b224", "casc2+b8"])
def test_micro_smoke2_brick_size_rows_match_jax(monkeypatch, row):
    """brick_size overrides (C1)."""
    rec = Recorder(monkeypatch, tfast, "render_tile")
    r, spp = sc.size("smoke")
    micro_smoke2.config_row(sc.scene("smoke", CPU), sc.camera(r, CPU), r,
                            spp, 1, row, dict(micro_smoke2.CONFIGS)[row])
    assert rec.calls[-1][0]["brick_size"] == dict(
        micro_smoke2.CONFIGS)[row]["brick_size"]
    check_fast_call(rec.calls[-1], "smoke")


def test_micro_smoke2_main_keys(tmp_path):
    res = run_main(micro_smoke2, ["--res", "8", "--spp", "1", "--reps", "1",
                                  "--no-stats", "--only", "casc2+b224"],
                   tmp_path, "micro_smoke2")
    assert list(res["results"]) == ["casc2+b224"]
    assert res["reference_best"] == 17.41


def test_micro_bucky_r5_matches_jax(monkeypatch, tmp_path):
    """main --only 1L: the JAX script's keys; the single-level call (C1)."""
    rec = Recorder(monkeypatch, tfast, "render_tile")
    res = run_main(micro_bucky_r5, ["--res", "8", "--spp", "1", "--reps",
                                    "1", "--only", "1L"], tmp_path,
                   "micro_bucky_r5")
    assert list(res) == ["1L"] and res["1L"]["precision"] == "f32"
    assert rec.calls[-1][0]["two_level"] is False
    check_fast_call(rec.calls[-1], "bucky")


def test_micro_config3_matches_jax(monkeypatch, tmp_path):
    """Config 3's .vdb read by both packages' loaders is bit for bit the
    same scene, also at scale 800; main --quick on the rows of the
    derivation: the JAX script's keys (the derivation's too) and the
    scale-800 call (C1)."""
    path = baseline_configs.write_hetvol_vdb(str(tmp_path))
    ts, _ = tvdb.load_vdb_scene(path, device="cpu")
    js, _ = jvdb.load_vdb_scene(path)
    assert_same_scene(ts, js)
    js800 = js._replace(medium=js.medium._replace(
        scale=jnp.asarray(800.0, jnp.float32)))
    assert_same_scene(micro_config3.with_scale(ts, 800.0), js800)
    rec = Recorder(monkeypatch, tfast, "render_tile")
    res = run_main(micro_config3, ["--quick", "--reps", "1", "--spp", "1",
                                   "--only", "_base"], tmp_path,
                   "micro_config3")
    assert list(res) == ["s100_400_base", "s100_1024_base", "s800_400_base",
                         "derivation"]
    assert res["s800_400_base"]["res"] == 64
    (img, nr), jout = replay(rec.calls[-1], jfast, js800)
    c1_allowance(img, nr, jout[0], jout[1])


def test_micro_smoke_brick_matches_jax(monkeypatch, tmp_path):
    """main --k 32 at 16^2 (brickSK's lanes come in rows of 128): the JAX
    script's keys; brickSK's call against JAX's with the Pallas tracking
    kernel in interpret mode (tests/test_torch_brick.py's tolerance)."""
    rec = Recorder(monkeypatch, tbrick, "render_tile")
    res = run_main(micro_smoke_brick, ["--res", "16", "--spp", "1", "--reps",
                                       "1", "--k", "32"], tmp_path,
                   "micro_smoke_brick")
    assert list(res) == ["fastSK-2L", "brickSK k=32"]
    assert rec.calls[-1][0]["k_steps"] == 32
    assert [r["kernels"] for r in res.values()] == [["fastbody"],
                                                   ["brickbody"]]
    (img, nr), jout = replay(rec.calls[-1], jbrick, jax_scene("smoke"),
                             interpret=True)
    family_exact(img, nr, jout[0], jout[1])


def jax_list(name, var, env):
    """The list literal assigned to `var` in the JAX script, evaluated with
    `env` (dict, base, the scenes' names)."""
    for node in ast.walk(ast.parse(jax_text(name))):
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and node.targets[0].id == var
                and isinstance(node.value, ast.List)):
            return eval(compile(ast.Expression(node.value), name, "eval"),
                        {"dict": dict, **env})
    raise AssertionError(f"no list {var} in {name}")


def test_sweeps_are_the_jax_scripts_sweeps():
    """Every row of the sweeps, name and keywords, evaluated from the JAX
    scripts' own list literals; micro_medical2's with_stats knobs."""
    base = {"base": dict(cascade_factor=2)}
    assert micro_medical2.SWEEP == jax_list("micro_medical2", "sweep", base)
    assert micro_smoke2.CONFIGS == jax_list("micro_smoke2", "configs", base)
    assert micro_bucky_r5.SWEEP == jax_list("micro_bucky_r5", "sweep", {})
    env = {"scene": "s100", "scene800": "s800", "r_lo": "lo", "r_hi": "hi",
           "base": dict(two_level=True, cascade_factor=2)}
    assert micro_config3.rows("s100", "s800", "lo", "hi") == jax_list(
        "micro_config3", "rows", env)
    assert ("stats_kw = dict(max_bricks=512, min_width=64, table_bits=4,\n"
            "                    cascade_factor=2)") in jax_text("micro_medical2")
    assert micro_medical2.STATS_KW == dict(max_bricks=512, min_width=64,
                                           table_bits=4, cascade_factor=2)


def test_row_counts_count_the_eager_evaluations():
    """On the CPU a row launches no kernel and reads no control word; its
    `eager` count is fastSK's eager-body evaluations, one per pool width
    of rows (render_tile's with_stats), and the family's last drain is
    none."""
    from cudavolumerenderer_tpu_torch.ops import fastbody

    r, spp = sc.size("medical")
    with sc.RowCounts() as rc:
        out = tfast.render_tile(
            sc.scene("medical", CPU), sc.camera(r, CPU),
            micro_stats.RenderSettings.from_flags(True), (r, r),
            torch.zeros(2), (r, r), spp, 3, 0, two_level=True,
            with_stats=True, cascade_factor=2, min_width=16, tail_chain=2)
    widths = tfast._cascade_widths(r * r, 2, 16)
    evals = sum(int(rows) // w for rows, w in zip(out[4].tolist(), widths))
    assert rc.counts["eager"] == fastbody.KERNEL.plain_evals == evals > 0
    assert {k: rc.counts[k] for k in ("fastbody", "familybody", "brickbody",
                                      "taildrain", "reads")} == dict.fromkeys(
        ("fastbody", "familybody", "brickbody", "taildrain", "reads"), 0)
    assert rc.counts["family_longest_lane"] is None
