"""The torch port's CLI: its configuration against the JAX package's for
the same argv, the batch mode end to end on the CPU with brickSK on a
tiny Mitsuba XML scene and with every scheduler on a tiny raw scene, and
the modes it refuses."""

import enum

import numpy as np
import pytest
import torch

from cudavolumerenderer_tpu import cli as jcli
from cudavolumerenderer_tpu_torch import cli
from cudavolumerenderer_tpu_torch.config import Kernel
from cudavolumerenderer_tpu_torch.utils.image import load_hdr
from test_torch_scene_io import write_raw, write_xml_scene

torch.set_num_threads(2)

ARGVS = [
    ["s.xml"],
    ["s.xml", "-k", "brickSK", "-i", "4", "-r", "400", "400", "--trials", "2"],
    ["s.raw", "-k", "fastsk", "--two-level", "--tail-pallas",
     "--tail-pk-width", "64", "--number-of-tiles", "3", "-r", "96",
     "--seed", "7", "-o", "out"],
    ["s.mhd", "--mitsuba-comparable", "false", "--table-bits", "8",
     "--allow-quantized", "--cascade-factor", "1.5", "--min-width", "512",
     "--max-bricks", "512", "--lanes-per-pixel", "2", "--scene-type", "Mhd"],
    ["s.vdb", "-k", "regenerationSK", "--regeneration-level", "2",
     "--n-lanes", "4096", "--boundary", "variable",
     "--boundary-threshold", "0.01", "--spec-width", "256",
     "--tail-spec", "2", "--tail-single-level", "--tail-bricks", "4",
     "--defer-ggx", "3", "--brick-major", "--interactive", "yes"],
]


def plain(v):
    return v.value if isinstance(v, enum.Enum) else v


@pytest.mark.parametrize("argv", ARGVS)
def test_config_from_args_matches_jax(argv):
    t = cli.config_from_args(cli.build_parser().parse_args(argv))
    j = jcli.config_from_args(jcli.build_parser().parse_args(argv))
    fields = [f for f in vars(t) if f != "settings"]
    assert {"algorithm", "trials", "interactive", "output_name"} <= set(fields)
    for name in fields:
        assert plain(getattr(t, name)) == plain(getattr(j, name)), name
    for name in vars(t.settings):
        assert getattr(t.settings, name) == getattr(j.settings, name), name
    assert t.to_string() == j.to_string()
    assert t.effective_table_bits == j.effective_table_bits


def test_run_test_brick_on_cpu(tmp_path, capsys):
    scene = write_xml_scene(tmp_path, scale=100.0)
    out = str(tmp_path / "out")
    args = cli.build_parser().parse_args(
        [scene, "-k", "brickSK", "-i", "2", "-r", "16", "16", "--trials", "2",
         "-o", out, "--platform", "cpu"]
    )
    result = cli.run_test(cli.config_from_args(args), torch.device("cpu"))
    printed = capsys.readouterr().out
    assert "--- trial 1" in printed and "millions of rays per sec" in printed
    assert result["n_rays"] > 0 and result["mrays_per_sec"] > 0
    img = load_hdr(out + ".hdr")
    assert img.shape == (16, 16, 3) and np.isfinite(img).all()
    assert 0.0 < img.mean() < 2.0
    assert (tmp_path / "out.png").read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"


def test_main_renders_on_cpu(tmp_path):
    scene = write_xml_scene(tmp_path, scale=100.0)
    out = str(tmp_path / "main")
    assert cli.main([scene, "-k", "brickSK", "-i", "1", "-r", "16", "8",
                     "-o", out, "--platform", "cpu"]) == 0
    assert load_hdr(out + ".hdr").shape == (8, 16, 3)


@pytest.mark.parametrize("kernel", [k.value for k in Kernel])
def test_every_kernel_renders_raw_scene_on_cpu(tmp_path, kernel):
    out = str(tmp_path / "k")
    assert cli.main([write_raw(tmp_path), "-k", kernel, "-i", "1", "-r", "16",
                     "8", "--n-lanes", "256", "-o", out,
                     "--platform", "cpu"]) == 0
    img = load_hdr(out + ".hdr")
    assert img.shape == (8, 16, 3) and np.isfinite(img).all()
    assert img.mean() > 0


@pytest.mark.parametrize("extra", [
    ["--tail-spec", "2"], ["--defer-ggx", "2"], ["--brick-major"],
])
def test_unported_modes_raise(tmp_path, extra):
    """These fastSK options raised through the CLI until they were ported
    (tests/test_torch_fast_options.py holds them against JAX); each now
    renders, and --defer-ggx and --brick-major (a layout) write the
    default render's image bit for bit."""
    scene = write_xml_scene(tmp_path)
    argv = [scene, "-i", "1", "-r", "8", "8", "--two-level", "--platform",
            "cpu"]
    assert cli.main(argv + ["-o", str(tmp_path / "opt"), *extra]) == 0
    img = load_hdr(str(tmp_path / "opt.hdr"))
    assert img.shape == (8, 8, 3) and np.isfinite(img).all()
    if extra[0] != "--tail-spec":
        assert cli.main(argv + ["-o", str(tmp_path / "ref")]) == 0
        np.testing.assert_array_equal(img, load_hdr(str(tmp_path / "ref.hdr")))


def test_cuda_platform_without_card_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    scene = write_xml_scene(tmp_path)
    with pytest.raises(RuntimeError, match="is_available"):
        cli.main([scene, "-k", "brickSK", "-r", "16", "16"])
