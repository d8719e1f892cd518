"""The port's scene side against the JAX package's: procedural volumes,
the MHD loader (raw file and zlib-compressed .mha), load_scene's camera
overrides, the albedo's affine fit and the pool-sizing rules, on the same
inputs.  Everything here is host-side numpy in both packages, so the
results must be exactly equal."""

import warnings
import zlib

import numpy as np
import pytest
import torch

from cudavolumerenderer_tpu import config as jconfig
from cudavolumerenderer_tpu.scene import loader as jloader
from cudavolumerenderer_tpu.scene import mhd as jmhd
from cudavolumerenderer_tpu.scene import procedural as jproc
from cudavolumerenderer_tpu.scene import types as jtypes
from cudavolumerenderer_tpu.utils import occupancy as jocc
from cudavolumerenderer_tpu_torch import config as tconfig
from cudavolumerenderer_tpu_torch.scene import loader as tloader
from cudavolumerenderer_tpu_torch.scene import mhd as tmhd
from cudavolumerenderer_tpu_torch.scene import procedural as tproc
from cudavolumerenderer_tpu_torch.scene import types as ttypes
from cudavolumerenderer_tpu_torch.utils import occupancy as tocc

torch.set_num_threads(2)


def same(t, j):
    t = t.numpy() if isinstance(t, torch.Tensor) else t
    np.testing.assert_array_equal(t, np.asarray(j))


@pytest.mark.parametrize("name,kwargs", [
    ("blob_volume", dict(resolution=(12, 10, 9), n_blobs=4, seed=5)),
    ("smoke_volume", dict(resolution=(16, 12, 8), seed=2)),
    ("medical_volume", dict(resolution=(14, 14, 10), n_blobs=6)),
])
def test_procedural_volumes_equal(name, kwargs):
    same(getattr(tproc, name)(**kwargs), getattr(jproc, name)(**kwargs))


def write_volume(tmp_path, kind, n=(9, 7, 6)):
    """A u16 volume as .mhd + .raw or as one zlib-compressed .mha."""
    nz, ny, nx = n[2], n[1], n[0]
    counts = (tproc.medical_volume(n, n_blobs=3) * 4095.0).astype("<u2")
    header = (
        "ObjectType = Image\nNDims = 3\nBinaryData = True\n"
        "BinaryDataByteOrderMSB = False\n"
        f"DimSize = {nx} {ny} {nz}\nElementType = MET_USHORT\n"
        "ElementSpacing = 1 1 1\n"
    )
    if kind == "mhd":
        counts.tofile(tmp_path / "v.raw")
        path = tmp_path / "v.mhd"
        path.write_text(header + "ElementDataFile = v.raw\n")
    else:
        path = tmp_path / "v.mha"
        path.write_bytes(
            (header + "CompressedData = True\nElementDataFile = LOCAL\n")
            .encode() + zlib.compress(counts.tobytes())
        )
    return str(path)


@pytest.mark.parametrize("kind", ["mhd", "mha"])
def test_mhd_scene_matches_jax(tmp_path, kind):
    path = write_volume(tmp_path, kind)
    same(tmhd.read_mhd(path), jmhd.read_mhd(path))
    x = np.linspace(-0.2, 1.2, 29, dtype=np.float32)
    same(tmhd.smooth_step(0.2, 0.6, x), jmhd.smooth_step(0.2, 0.6, x))
    ts, tc = tmhd.load_mhd_scene(path, device="cpu")
    js, jc = jmhd.load_mhd_scene(path)
    tm, jm = ts.medium, js.medium
    for name in ("box_min", "box_max", "scale", "max_density", "g",
                 "albedo_affine"):
        same(getattr(tm, name), getattr(jm, name))
    same(tm.density.data, jm.density.data)
    same(tm.albedo.data, jm.albedo.data)
    same(ts.bsdf.roughness, js.bsdf.roughness)
    same(ts.bsdf.eta, js.bsdf.eta)
    same(ts.le, js.le)
    same(tc.inv_view, jc.inv_view)
    same(tc.raster_to_view, jc.raster_to_view)


@pytest.mark.parametrize("mitsuba", [True, False])
def test_load_scene_camera_overrides_match_jax(tmp_path, mitsuba):
    path = write_volume(tmp_path, "mhd")
    kw = dict(scene_file=path, resolution=(40, 24))
    _, tc = tloader.load_scene(tconfig.Config(
        **kw, settings=ttypes.RenderSettings.from_flags(mitsuba)),
        device="cpu")
    _, jc = jloader.load_scene(jconfig.Config(
        **kw, settings=jtypes.RenderSettings.from_flags(mitsuba)))
    same(tc.inv_view, jc.inv_view)
    same(tc.raster_to_view, jc.raster_to_view)


@pytest.mark.parametrize("affine", [True, False])
def test_affine_albedo_fit_matches_jax(affine):
    rs = np.random.RandomState(4)
    d = rs.rand(6, 5, 4).astype(np.float32)
    albedo = np.stack([0.8 * d + 0.1, 0.3 * np.ones_like(d), 1.0 - d], -1)
    if not affine:
        albedo[2, 3, 1, 1] += 0.25
    t_aff = ttypes.make_medium(d, albedo, device="cpu").albedo_affine
    j_aff = jtypes.make_medium(d, albedo).albedo_affine
    assert (t_aff is None) == (j_aff is None) == (not affine)
    if affine:
        same(t_aff, j_aff)


GIB = 1 << 30


@pytest.mark.parametrize("n_pix,spp,grid,budget", [
    (512 * 512, 4, (256, 256, 256), 80 * GIB),
    (64 * 64, 1, (32, 32, 32), 16 * GIB),
    (1920 * 1080, 20, (1024, 1024, 1024), 16 * GIB),
    (100, 3, (8, 8, 8), 1 << 24),
])
def test_pool_sizing_matches_jax(n_pix, spp, grid, budget):
    assert tocc.pick_n_lanes(n_pix, spp, grid, budget=budget) == (
        jocc.pick_n_lanes(n_pix, spp, grid, budget=budget)
    )
    try:
        want = jocc.plan_albedo_table(grid, budget=budget)
    except MemoryError:
        with pytest.raises(MemoryError):
            tocc.plan_albedo_table(grid, budget=budget)
    else:
        assert tocc.plan_albedo_table(grid, budget=budget) == want
    for lanes in (1 << 12, 1 << 24):
        with warnings.catch_warnings(record=True) as tw:
            warnings.simplefilter("always")
            tocc.validate_pool(lanes, grid, budget=budget)
        with warnings.catch_warnings(record=True) as jw:
            warnings.simplefilter("always")
            jocc.validate_pool(lanes, grid, budget=budget)
        assert len(tw) == len(jw)


def test_cpu_budget_is_host_memory():
    assert tocc.device_memory_budget("cpu") > 0
    assert tocc.device_memory_budget() == tocc.device_memory_budget("cpu")


def test_constructors_default_to_card_and_raise_without_one(monkeypatch):
    """make_camera, make_camera_look_at, make_medium and
    CameraController.camera build on the card by default, as the scene
    loaders do: without one they raise, and device="cpu" builds on the
    CPU."""
    from cudavolumerenderer_tpu_torch.ops import camera as tcam
    from cudavolumerenderer_tpu_torch.ops.camera_controller import (
        CameraController,
    )

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    d = np.ones((4, 4, 4), np.float32)
    for build in (
        lambda **kw: tcam.make_camera(8, 8, **kw),
        lambda **kw: tcam.make_camera_look_at(
            (0, 0, 100), (0, 0, 0), (0, 1, 0), 8, 8, 0.7, **kw),
        lambda **kw: CameraController(8, 8).camera(**kw),
        lambda **kw: ttypes.make_medium(d, 0.9, **kw),
    ):
        with pytest.raises(RuntimeError, match="CUDA card"):
            build()
        assert build(device="cpu") is not None
