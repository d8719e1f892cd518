"""Scene I/O and image output of the torch port against the JAX package,
on files written in tmp_path: the .vol reader/writer, the Mitsuba XML
and RAW builders (transfer function included), the loader's dispatch,
the loaders' default device, and the HDR/PNG writers.  Every comparison
is exact: both packages run the same numpy code on the same bytes."""

import inspect

import numpy as np
import pytest
import torch

from cudavolumerenderer_tpu import config as jconfig
from cudavolumerenderer_tpu.scene import loader as jloader
from cudavolumerenderer_tpu.scene import raw_builder as jraw
from cudavolumerenderer_tpu.scene import vol as jvol
from cudavolumerenderer_tpu.scene import xml_builder as jxml
from cudavolumerenderer_tpu.scene.types import RenderSettings as JRS
from cudavolumerenderer_tpu.utils import image as jimage
from cudavolumerenderer_tpu_torch.config import Config, SceneType
from cudavolumerenderer_tpu_torch.scene import mhd, procedural, raw_builder
from cudavolumerenderer_tpu_torch.scene import vdb, vol
from cudavolumerenderer_tpu_torch.scene import xml_builder
from cudavolumerenderer_tpu_torch.scene.loader import load_scene
from cudavolumerenderer_tpu_torch.scene.types import RenderSettings as TRS
from cudavolumerenderer_tpu_torch.utils import image

XML = """<scene version="0.5.0">
  <medium type="heterogeneous" id="smoke">
    <volume name="density" type="gridvolume">
      <string name="filename" value="density.vol"/>
    </volume>
    <volume name="albedo" type="gridvolume">
      <string name="filename" value="albedo.vol"/>
    </volume>
    <float name="scale" value="{scale}"/>
  </medium>
  <sensor type="perspective">
    <float name="fov" value="0.7"/>
    <film type="hdrfilm">
      <integer name="width" value="{w}"/>
      <integer name="height" value="{h}"/>
    </film>
  </sensor>
</scene>
"""


def write_xml_scene(tmp_path, shape=(16, 16, 8), scale=800.0, w=16, h=16):
    """A smoke scene in the reference's XML format: density.vol and an
    RGB albedo.vol of 0.9 * density, box [-0.5, 0.5]^3."""
    d = procedural.smoke_volume(shape).astype(np.float32)
    alb = 0.9 * np.stack([d, d, d], axis=-1)
    box = ((-0.5, -0.5, -0.5), (0.5, 0.5, 0.5))
    vol.write_vol(str(tmp_path / "density.vol"), d, *box)
    vol.write_vol(str(tmp_path / "albedo.vol"), alb.astype(np.float32), *box)
    path = tmp_path / "scene.xml"
    path.write_text(XML.format(scale=scale, w=w, h=h))
    return str(path)


def write_raw(tmp_path):
    path = str(tmp_path / "bucky_synth.raw")
    procedural.write_raw_uchar(path, procedural.blob_volume())
    return path


def assert_scene_equal(ts, tc, js, jc):
    tm, jm = ts.medium, js.medium
    for a, b in (
        (tm.density.data, jm.density.data), (tm.albedo.data, jm.albedo.data),
        (tm.box_min, jm.box_min), (tm.box_max, jm.box_max),
        (tm.scale, jm.scale), (tm.max_density, jm.max_density), (tm.g, jm.g),
        (ts.bsdf.roughness, js.bsdf.roughness), (ts.bsdf.eta, js.bsdf.eta),
        (ts.le, js.le), (tc.inv_view, jc.inv_view),
        (tc.raster_to_view, jc.raster_to_view),
    ):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert (tm.albedo_affine is None) == (jm.albedo_affine is None)
    if tm.albedo_affine is not None:
        np.testing.assert_array_equal(
            tm.albedo_affine.numpy(), np.asarray(jm.albedo_affine)
        )


@pytest.mark.parametrize("channels", [1, 3])
def test_vol_round_trip_and_jax_reader(tmp_path, channels):
    rs = np.random.RandomState(channels)
    shape = (5, 6, 7) + ((channels,) if channels > 1 else ())
    data = rs.rand(*shape).astype(np.float32)
    path = str(tmp_path / "v.vol")
    vol.write_vol(path, data, (-1.0, -0.5, 0.0), (1.0, 0.5, 2.0))
    got, want = vol.read_vol(path), jvol.read_vol(path)
    np.testing.assert_array_equal(got.data, data)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got.box_max, [1.0, 0.5, 2.0])


@pytest.mark.parametrize("scale, film", [(800.0, (24, 12)), (40.0, (16, 16))])
def test_load_xml_scene_equals_jax(tmp_path, scale, film):
    path = write_xml_scene(tmp_path, scale=scale, w=film[0], h=film[1])
    ts, tc = xml_builder.load_xml_scene(path, device="cpu")
    js, jc = jxml.load_xml_scene(path)
    assert_scene_equal(ts, tc, js, jc)
    assert float(ts.medium.scale) == scale
    assert ts.medium.density.data.shape == (8, 16, 16)
    assert ts.medium.albedo_affine is not None  # albedo 0.9 * density


def test_transfer_function_and_albedo_equal_jax():
    np.testing.assert_array_equal(
        raw_builder.transfer_function(), jraw.transfer_function()
    )
    d = np.random.RandomState(4).rand(7, 8, 9).astype(np.float32)
    d[0, 0, :3] = (0.0, 1.0, 0.5)
    np.testing.assert_array_equal(
        raw_builder.albedo_from_density(d), jraw.albedo_from_density(d)
    )


def test_load_raw_scene_equals_jax(tmp_path):
    path = write_raw(tmp_path)
    ts, tc = raw_builder.load_raw_scene(path, device="cpu")
    js, jc = jraw.load_raw_scene(path)
    assert_scene_equal(ts, tc, js, jc)
    with pytest.raises(ValueError, match="bytes"):
        raw_builder.load_raw_scene(path, resolution=(64, 64, 64),
                                   device="cpu")


@pytest.mark.parametrize("kind", ["xml", "raw"])
@pytest.mark.parametrize("comparable", [True, False])
def test_loader_dispatch_equals_jax(tmp_path, kind, comparable):
    path = write_xml_scene(tmp_path) if kind == "xml" else write_raw(tmp_path)
    ts, tc = load_scene(Config(scene_file=path, resolution=(32, 16),
                               settings=TRS.from_flags(comparable)),
                        device="cpu")
    js, jc = jloader.load_scene(jconfig.Config(
        scene_file=path, resolution=(32, 16),
        settings=JRS.from_flags(comparable)))
    assert_scene_equal(ts, tc, js, jc)
    stype = SceneType.MITSUBA_XML if kind == "xml" else SceneType.RAW
    ts2, _ = load_scene(Config(scene_file=path, scene_type=stype),
                        device="cpu")
    assert torch.equal(ts2.medium.density.data, ts.medium.density.data)


def write_mhd(tmp_path):
    """A 4^3 u16 MHD scene (header + raw counts)."""
    counts = np.arange(64, dtype="<u2").reshape(4, 4, 4) * 60
    counts.tofile(str(tmp_path / "v.raw"))
    path = tmp_path / "v.mhd"
    path.write_text(
        "ObjectType = Image\nNDims = 3\nBinaryData = True\n"
        "BinaryDataByteOrderMSB = False\nDimSize = 4 4 4\n"
        "ElementType = MET_USHORT\nElementDataFile = v.raw\n"
    )
    return str(path)


def write_vdb(tmp_path):
    path = str(tmp_path / "v.vdb")
    vdb.write_vdb(path, procedural.smoke_volume((16, 16, 8)))
    return path


def write_npz(tmp_path):
    d = procedural.smoke_volume((16, 16, 8)).astype(np.float32)
    path = str(tmp_path / "v.npz")
    vdb.save_npz(path, d, np.stack([d, d, d], axis=-1))
    return path


# each loader and a scene file it reads
LOADERS = {
    "load_scene": (load_scene, write_xml_scene,
                   lambda p: (Config(scene_file=p),)),
    "load_mhd_scene": (mhd.load_mhd_scene, write_mhd, lambda p: (p,)),
    "load_xml_scene": (xml_builder.load_xml_scene, write_xml_scene,
                       lambda p: (p,)),
    "load_raw_scene": (raw_builder.load_raw_scene, write_raw, lambda p: (p,)),
    "load_vdb_scene": (vdb.load_vdb_scene, write_vdb, lambda p: (p,)),
    "load_npz_scene": (vdb.load_npz_scene, write_npz, lambda p: (p,)),
}


@pytest.mark.parametrize("name", sorted(LOADERS))
def test_loaders_default_to_the_card(tmp_path, monkeypatch, name):
    """Every loader builds on "cuda" unless asked for the CPU; without a
    card the default raises and names the way out, with no fallback."""
    loader, write, args = LOADERS[name]
    assert inspect.signature(loader).parameters["device"].default == "cuda"
    path = write(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='pass device="cpu"'):
        loader(*args(path))
    scene, camera = loader(*args(path), device="cpu")
    assert scene.device.type == "cpu" and camera.inv_view.device.type == "cpu"


def test_image_writers_equal_jax(tmp_path):
    rs = np.random.RandomState(8)
    img = (rs.rand(6, 9, 3) * 4.0).astype(np.float32)
    img[0, 0] = 0.0
    np.testing.assert_array_equal(image.tonemap(img, 0.5),
                                  jimage.tonemap(img, 0.5))
    np.testing.assert_array_equal(image._rgbe_encode(img),
                                  jimage._rgbe_encode(img))
    image.save_hdr(str(tmp_path / "a.hdr"), img)
    back = image.load_hdr(str(tmp_path / "a.hdr"))
    np.testing.assert_array_equal(back, jimage.load_hdr(str(tmp_path / "a.hdr")))
    # RGBE keeps 8 bits of mantissa per channel, relative to the max
    np.testing.assert_allclose(back, img, rtol=0, atol=img.max() / 128)
    image.save_png(str(tmp_path / "a.png"), image.tonemap(img))
    jimage.save_png(str(tmp_path / "b.png"), jimage.tonemap(img))
    assert (tmp_path / "a.png").read_bytes() == (tmp_path / "b.png").read_bytes()
