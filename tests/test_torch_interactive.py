"""The port's headless interactive modes and its BASELINE configs driver on
the CPU: `--interactive` (time-budgeted progressive frames and the final
.hdr), `--orbit` and `--camera-path` write the JAX CLI's frame files, and
benchmarks/baseline_configs writes the JAX script's scene files byte for
byte and runs its configs through cli.run_test."""

import importlib.util
import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch

from cudavolumerenderer_tpu_torch import cli
from cudavolumerenderer_tpu_torch.benchmarks import baseline_configs as bc
from cudavolumerenderer_tpu_torch.utils.image import load_hdr
from test_torch_scene_io import write_xml_scene

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def jax_baseline_configs():
    spec = importlib.util.spec_from_file_location(
        "jax_baseline_configs",
        os.path.join(ROOT, "benchmarks", "baseline_configs.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def frames(tmp_path, prefix):
    return sorted(p.name for p in tmp_path.iterdir() if p.name.startswith(prefix))


@pytest.mark.parametrize("tiles", [["1"], ["2", "2"]])
def test_orbit_writes_frames(tmp_path, tiles):
    scene = write_xml_scene(tmp_path, scale=100.0)
    out = str(tmp_path / "orb")
    assert cli.main([scene, "--interactive", "1", "--orbit", "2", "-i", "2",
                     "-r", "16", "16", "--number-of-tiles", *tiles, "-o", out,
                     "--platform", "cpu"]) == 0
    assert frames(tmp_path, "orb") == ["orb_orbit0000.png", "orb_orbit0001.png"]


def test_progressive_interactive_writes_frames_and_hdr(tmp_path, capsys):
    scene = write_xml_scene(tmp_path, scale=100.0)
    out = str(tmp_path / "prog")
    assert cli.main([scene, "--interactive", "yes", "-i", "3", "-r", "16",
                     "16", "--number-of-tiles", "2", "-o", out,
                     "--platform", "cpu"]) == 0
    names = frames(tmp_path, "prog")
    n = capsys.readouterr().out.count("dumped")
    assert 1 <= n <= 3  # one frame per 0.1 s budget, at most one per pass
    assert names == sorted(
        [f"prog_frame{i:04d}.png" for i in range(1, n + 1)] + ["prog.hdr"])
    img = load_hdr(out + ".hdr")
    assert img.shape == (16, 16, 3) and np.isfinite(img).all()


def test_camera_path_needs_interactive(tmp_path):
    """As in the JAX CLI, --camera-path and --orbit act only with
    --interactive; without it the batch mode runs."""
    scene = write_xml_scene(tmp_path, scale=100.0)
    out = str(tmp_path / "b")
    assert cli.main([scene, "--orbit", "3", "--camera-path", "absent.txt",
                     "-i", "1", "-r", "8", "8", "-o", out,
                     "--platform", "cpu"]) == 0
    assert frames(tmp_path, "b") == ["b.hdr", "b.png"]


def test_scene_writers_equal_jax(tmp_path):
    jbc = jax_baseline_configs()
    for ours, theirs in ((bc.write_hetvol_vdb, jbc._write_hetvol_vdb),
                         (bc.write_bucky, jbc._write_bucky)):
        (tmp_path / "t").mkdir(exist_ok=True)
        (tmp_path / "j").mkdir(exist_ok=True)
        a = ours(str(tmp_path / "t"))
        b = theirs(str(tmp_path / "j"))
        assert os.path.basename(a) == os.path.basename(b)
        assert Path(a).read_bytes() == Path(b).read_bytes()
    a, b = (bc.write_mitsuba_xml(str(tmp_path / "t")),
            jbc._write_mitsuba_xml(str(tmp_path / "j")))
    for name in ("density.vol", "albedo.vol"):
        assert ((tmp_path / "t" / name).read_bytes()
                == (tmp_path / "j" / name).read_bytes())
    assert os.path.basename(a) == os.path.basename(b)


def test_rows_equal_jax_table():
    """The four configs: names, kernels, sizes, tiles and reference rows of
    the JAX script (benchmarks/baseline_configs.py:138-151)."""
    for quick in (False, True):
        got = [(n, k.value, r, i, t, ref) for n, _, k, r, i, t, ref
               in bc.rows(quick)]
        assert [g[0] for g in got] == [
            "1_bucky_raw_256_20it", "2_medical_mhd_512", "3_hetvol_vdb_1024",
            "4_mitsubaxml_10x10_50it"]
        assert {g[1] for g in got} == {"fastSK"}
    full = {n: (r, i, t) for n, _, _, r, i, t, _ in bc.rows(False)}
    assert full["3_hetvol_vdb_1024"] == (1024, 4, (1, 1))
    assert full["4_mitsubaxml_10x10_50it"] == (400, 50, (10, 10))


def test_quick_config3_on_cpu(tmp_path, capsys):
    out = str(tmp_path / "r.json")
    assert bc.main(["--platform", "cpu", "--quick", "--only", "3_",
                    "--trials", "1", "--out", out,
                    "--workdir", str(tmp_path)]) == 0
    with open(out) as f:
        rows = json.load(f)
    assert list(rows) == ["3_hetvol_vdb_1024"]
    row = rows["3_hetvol_vdb_1024"]
    assert row["resolution"] == 64 and row["iterations"] == 4
    assert row["n_rays"] > 0 and row["mrays_per_sec"] > 0
    assert row["precision"] == "f32" and row["scene_version"] == "r3"
    img = load_hdr(str(tmp_path / "3_hetvol_vdb_1024.hdr"))
    assert img.shape == (64, 64, 3) and np.isfinite(img).all()
    assert "millions of rays per sec" in capsys.readouterr().out


def test_champion_raises_not_ported(tmp_path):
    """--champion raised the not-ported error until the packed q4 tables
    were ported; now it renders its rows, labelled q4-reduced (the quick
    bucky row here; tests/test_torch_packed.py holds its Config fields
    against the JAX script's)."""
    out = str(tmp_path / "r.json")
    assert bc.main(["--platform", "cpu", "--quick", "--champion", "--only",
                    "1_", "--trials", "1", "--out", out,
                    "--workdir", str(tmp_path)]) == 0
    with open(out) as f:
        rows = json.load(f)
    assert list(rows) == ["1_bucky_raw_256_20it"]
    row = rows["1_bucky_raw_256_20it"]
    assert row["precision"] == "q4-reduced" and row["n_rays"] > 0
    img = load_hdr(str(tmp_path / "1_bucky_raw_256_20it.hdr"))
    assert img.shape == (64, 64, 3) and np.isfinite(img).all()
