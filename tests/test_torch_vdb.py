"""The port's VDB/NPZ scene path against the JAX package: the .vdb writer's
bytes for every compression mode, the native reader (the port builds its
own copy of csrc/cvr_vdb.cpp) against JAX's, the blosc codec matrix and
the missing-grid error of tests/test_vdb.py, the NPZ round trip, and
load_scene on .vdb/.npz files against JAX's media, bit for bit."""

import ctypes
import ctypes.util

import numpy as np
import pytest

from cudavolumerenderer_tpu import config as jconfig
from cudavolumerenderer_tpu.scene import loader as jloader
from cudavolumerenderer_tpu.scene import vdb as jvdb
from cudavolumerenderer_tpu.scene.types import RenderSettings as JRS
from cudavolumerenderer_tpu.utils import native as jnative
from cudavolumerenderer_tpu_torch.config import Config
from cudavolumerenderer_tpu_torch.scene import vdb
from cudavolumerenderer_tpu_torch.scene.loader import load_scene
from cudavolumerenderer_tpu_torch.scene.types import RenderSettings as TRS
from cudavolumerenderer_tpu_torch.utils import native
from test_torch_scene_io import assert_scene_equal


def sparse_volume(shape=(21, 29, 37), seed=5):
    rs = np.random.RandomState(seed)
    d = rs.rand(*shape).astype(np.float32)
    d[d < 0.7] = 0.0  # sparsity incl. fully-empty leaves
    d[:, 8:16, :] = 0.0
    return d


def sparse_albedo(d):
    alb = np.stack([d, 0.5 * (d > 0), 1.0 - d], axis=-1).astype(np.float32)
    alb[d == 0] = 0.0
    return alb


def active_crop(d, a):
    """a cropped to d's nonzero (z, y, x) extent, and that extent as the
    reader's (x0, y0, z0, x1, y1, z1) bbox."""
    nz = np.nonzero(d)
    lo, hi = [x.min() for x in nz], [x.max() for x in nz]
    crop = a[lo[0]:hi[0] + 1, lo[1]:hi[1] + 1, lo[2]:hi[2] + 1]
    return crop, lo[::-1] + hi[::-1]


@pytest.mark.parametrize("with_albedo", [False, True])
@pytest.mark.parametrize("compression", ["zip", "none", "blosc"])
def test_write_vdb_bytes_equal_jax(tmp_path, compression, with_albedo):
    d = sparse_volume()
    alb = sparse_albedo(d) if with_albedo else None
    ours, theirs = tmp_path / "t.vdb", tmp_path / "j.vdb"
    vdb.write_vdb(str(ours), d, alb, compression=compression)
    jvdb.write_vdb(str(theirs), d, alb, compression=compression)
    assert ours.read_bytes() == theirs.read_bytes()
    with pytest.raises(ValueError, match="compression"):
        vdb.write_vdb(str(ours), d, compression="lzma")


@pytest.mark.parametrize("compression", ["zip", "none", "blosc"])
def test_density_round_trip_equals_jax_reader(tmp_path, compression):
    d = sparse_volume()
    path = str(tmp_path / f"rt_{compression}.vdb")
    vdb.write_vdb(path, d, compression=compression)
    bbox, channels = native.vdb_grid_info(path, "density")
    jbbox, jchannels = jnative.vdb_grid_info(path, "density")
    crop, want_bbox = active_crop(d, d)
    assert channels == jchannels == 1
    assert list(bbox) == list(jbbox) == want_bbox
    got, _ = native.vdb_densify(path, "density", 1)
    np.testing.assert_array_equal(got[..., 0], crop)
    np.testing.assert_array_equal(got, jnative.vdb_densify(path, "density", 1)[0])


def test_vec3s_albedo_round_trip_equals_jax_reader(tmp_path):
    d = sparse_volume()
    alb = sparse_albedo(d)
    path = str(tmp_path / "rt3.vdb")
    vdb.write_vdb(path, d, alb)
    got, bbox = native.vdb_densify(path, "albedo", 3)
    np.testing.assert_array_equal(got, active_crop(d, alb)[0])
    want, jbbox = jnative.vdb_densify(path, "albedo", 3)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(bbox, jbbox)
    # over a given (x, y, z) bbox: the density's, one voxel wider in x
    box = np.array(bbox, np.int32)
    box[3] += 1
    wide, _ = native.vdb_densify(path, "albedo", 3, bbox=box)
    assert wide.shape == got.shape[:2] + (got.shape[2] + 1, 3)
    np.testing.assert_array_equal(wide[:, :, :-1], got)
    with pytest.raises(RuntimeError, match="3 channels, expected 1"):
        native.vdb_densify(path, "albedo", 1)


def test_missing_grid_raises(tmp_path):
    path = str(tmp_path / "nogrid.vdb")
    vdb.write_vdb(path, sparse_volume())
    with pytest.raises((KeyError, RuntimeError)):
        native.vdb_grid_info(path, "albedo")
    with pytest.raises(RuntimeError, match="cvr_vdb"):
        native.vdb_grid_info(str(tmp_path / "absent.vdb"), "density")


def test_larger_grid_multiple_internal2(tmp_path):
    # spans several Internal2 nodes (>128 voxels along x)
    rs = np.random.RandomState(9)
    d = np.zeros((17, 40, 300), np.float32)
    d[3:12, 5:30, 10:290] = (
        rs.rand(9, 25, 280).astype(np.float32) > 0.6
    ) * rs.rand(9, 25, 280).astype(np.float32)
    ours, theirs = tmp_path / "big.vdb", tmp_path / "jbig.vdb"
    vdb.write_vdb(str(ours), d)
    jvdb.write_vdb(str(theirs), d)
    assert ours.read_bytes() == theirs.read_bytes()
    got, _ = native.vdb_densify(str(ours), "density", 1)
    np.testing.assert_array_equal(got[..., 0], active_crop(d, d)[0])


def blosc_libs():
    try:
        bl = ctypes.CDLL(ctypes.util.find_library("blosc") or "libblosc.so.1")
    except OSError:
        pytest.skip("system libblosc not available")
    bl.blosc_compress_ctx.restype = ctypes.c_int
    return bl, native.load()


def blosc_compress(bl, data: bytes, typesize: int, codec: bytes):
    out = ctypes.create_string_buffer(len(data) + 64)
    n = bl.blosc_compress_ctx(9, 1, typesize, len(data), data, out,
                              len(data) + 64, codec, 0, 1)
    return out.raw[:n] if n > 0 else None


@pytest.mark.parametrize("codec", [b"lz4", b"lz4hc"])
def test_blosc_decoder_round_trip_matrix(codec):
    """The port's build of the from-scratch blosc1 chunk decoder against
    the system c-blosc compressor: memcpyed / split / non-split /
    multi-block / leftover-block chunks, typesizes 1-8."""
    bl, cv = blosc_libs()
    rs = np.random.RandomState(0)
    n_checked = 0
    for nel in [1, 33, 100, 512, 5000, 65536, 1 << 19]:
        for kind in ["rand", "sparse", "const", "ramp"]:
            if kind == "ramp":
                a = np.arange(nel, dtype=np.float32)
            elif kind == "const":
                a = np.full(nel, 3.14, np.float32)
            else:
                a = rs.rand(nel).astype(np.float32)
                if kind == "sparse":
                    a[a < 0.7] = 0
            data = a.tobytes()
            for ts in [4, 1, 8]:
                if len(data) % ts:
                    continue
                z = blosc_compress(bl, data, ts, codec)
                if z is None:
                    continue
                dst = ctypes.create_string_buffer(len(data))
                rc = cv.cvr_blosc_decompress(z, len(z), dst, len(data))
                assert rc == 0, (nel, kind, ts, cv.cvr_vdb_last_error())
                assert dst.raw == data, (nel, kind, ts)
                n_checked += 1
    assert n_checked > 50


def test_blosc_decoder_rejects_unsupported_codec():
    bl, cv = blosc_libs()
    data = np.arange(256, dtype=np.float32).tobytes()
    z = blosc_compress(bl, data, 4, b"blosclz")
    if z is None:
        pytest.skip("blosclz unavailable in system blosc")
    dst = ctypes.create_string_buffer(len(data))
    rc = cv.cvr_blosc_decompress(z, len(z), dst, len(data))
    # memcpyed chunks decode regardless of codec; compressed blosclz
    # chunks are rejected with a clear error
    if z[2] & 0x2:
        assert rc == 0
    else:
        assert rc == -1 and b"codec" in cv.cvr_vdb_last_error()


def test_npz_round_trip_equals_jax(tmp_path):
    d = sparse_volume()
    alb = sparse_albedo(d)
    path = str(tmp_path / "s.npz")
    vdb.save_npz(path, d, alb)
    with np.load(path) as a:
        np.testing.assert_array_equal(a["density"], d)
        np.testing.assert_array_equal(a["albedo"], alb)
        np.testing.assert_array_equal(a["brick_max_density"],
                                      jvdb.brick_max_density(d))
        assert int(a["brick_size"]) == vdb.BRICK == jvdb.BRICK
    ts, tc = vdb.load_npz_scene(path, device="cpu")
    js, jc = jvdb.load_npz_scene(path)
    assert_scene_equal(ts, tc, js, jc)


def test_brick_max_density_equals_jax():
    d = np.random.RandomState(4).rand(9, 17, 20).astype(np.float32)
    for brick in (8, 4, 3):
        np.testing.assert_array_equal(vdb.brick_max_density(d, brick),
                                      jvdb.brick_max_density(d, brick))


@pytest.mark.parametrize("with_albedo", [False, True])
def test_load_vdb_scene_equals_jax(tmp_path, with_albedo):
    d = sparse_volume()
    alb = np.stack([d, d, d], axis=-1) if with_albedo else None
    path = str(tmp_path / "scene.vdb")
    vdb.write_vdb(path, d, alb)
    ts, tc = vdb.load_vdb_scene(path, device="cpu")
    js, jc = jvdb.load_vdb_scene(path)
    assert_scene_equal(ts, tc, js, jc)
    # VDBSceneBuilder conventions (reference: VDBSceneBuilder.h:40-80)
    assert float(ts.medium.scale) == 100.0
    assert float(ts.medium.max_density) == float(d.max())
    assert ts.medium.albedo_affine is not None  # albedo == density, or ones


@pytest.mark.parametrize("comparable", [True, False])
@pytest.mark.parametrize("kind", ["vdb", "npz"])
def test_load_scene_dispatch_equals_jax(tmp_path, kind, comparable):
    d = sparse_volume()
    alb = 0.9 * np.stack([d, d, d], axis=-1).astype(np.float32)
    path = str(tmp_path / f"scene.{kind}")
    if kind == "vdb":
        vdb.write_vdb(path, d, alb)
    else:
        vdb.save_npz(path, d, alb)
    ts, tc = load_scene(Config(scene_file=path, resolution=(32, 16),
                               settings=TRS.from_flags(comparable)),
                        device="cpu")
    js, jc = jloader.load_scene(jconfig.Config(
        scene_file=path, resolution=(32, 16),
        settings=JRS.from_flags(comparable)))
    assert_scene_equal(ts, tc, js, jc)


def test_convert_needs_pyopenvdb(tmp_path):
    for module in (vdb, jvdb):
        with pytest.raises(RuntimeError, match="pyopenvdb"):
            module.convert_vdb_to_npz(str(tmp_path / "a.vdb"),
                                      str(tmp_path / "a.npz"))
