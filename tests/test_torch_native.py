"""The port's native data-path library (utils/native.py): built by g++ from
the repository's csrc/*.cpp into the package's _build/ directory, never
the prebuilt csrc/libcvr_native.so, and held against the JAX package's
bindings and NumPy paths (the analogs of tests/test_native.py)."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from cudavolumerenderer_tpu.utils import image as jimage
from cudavolumerenderer_tpu.utils import native as jnative
from cudavolumerenderer_tpu_torch.utils import native
from cudavolumerenderer_tpu_torch.utils.cuda_build import BUILD_DIR


@pytest.fixture
def jax_numpy_paths():
    """The JAX bindings with their library hidden: every entry point takes
    its pure-NumPy path."""
    saved = jnative._LIB, jnative._TRIED
    jnative._LIB, jnative._TRIED = None, True
    yield jnative
    jnative._LIB, jnative._TRIED = saved


def test_builds_into_the_package_build_dir():
    lib = native.load()
    path = Path(lib._name)
    assert path.parent == BUILD_DIR and path == native.library_path()
    assert path.name != "libcvr_native.so"
    assert [s.name for s in native.SOURCES] == ["cvr_native.cpp", "cvr_vdb.cpp"]
    assert "-march=native" not in native.CXX_FLAGS


def test_failed_build_raises(tmp_path, monkeypatch):
    bad = tmp_path / "broken.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCES", (bad,))
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(native, "_LIB", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed on broken.cpp"):
        native.load()
    assert not list((tmp_path / "_build").glob("*.so"))


def test_morton_known_codes_and_jax(jax_numpy_paths):
    v = np.random.RandomState(0).rand(8, 8, 8).astype(np.float32)
    m = native.morton_reorder(v)
    # interleave x*4 + y*2 + z: voxel (x,y,z)=(1,0,0) -> code 4
    assert m[4] == v[0, 0, 1]
    assert m[2] == v[0, 1, 0]
    assert m[1] == v[1, 0, 0]
    assert m[7] == v[1, 1, 1]
    np.testing.assert_array_equal(m, jax_numpy_paths.morton_reorder(v))
    with pytest.raises(ValueError, match="power-of-two"):
        native.morton_reorder(np.zeros((4, 4, 8), np.float32))


@pytest.mark.parametrize("channels", [1, 4])
def test_brick_pack_matches_jax_numpy(jax_numpy_paths, channels):
    shape = (10, 9, 17) + ((channels,) if channels > 1 else ())
    v = np.random.RandomState(1).rand(*shape).astype(np.float32)
    nb, bm, dims = native.brick_pack(v)
    fb, fm, fdims = jax_numpy_paths.brick_pack(v)
    np.testing.assert_array_equal(nb, fb)
    np.testing.assert_array_equal(bm, fm)
    assert dims == fdims == (3, 3, 3)


def test_brick_max_is_majorant(jax_numpy_paths):
    v = np.random.RandomState(2).rand(8, 8, 16).astype(np.float32)
    bm = native.brick_max(v)
    assert bm.shape == (2, 2, 2)
    np.testing.assert_allclose(bm[0, 0, 0], v[:4, :4, :8].max())
    assert bm.max() <= v.max() + 1e-7
    np.testing.assert_array_equal(bm, jax_numpy_paths.brick_max(v))


def test_rgbe_roundtrip_and_jax():
    rgb = np.random.RandomState(3).rand(64, 3).astype(np.float32) * 4
    rgb[0] = 0.0
    e = native.rgbe_encode(rgb)
    back = jimage._rgbe_decode(e)
    # shared-exponent format: error bound is max_component / 256
    tol = rgb.max(axis=-1, keepdims=True) / 128.0
    assert np.all(np.abs(back - rgb) <= tol)
    np.testing.assert_array_equal(e, jnative.rgbe_encode(rgb))


def test_concurrent_first_uses_build_once(tmp_path):
    """Three processes loading at once into an empty build directory: the
    lock file lets exactly one of them run g++, and all three load."""
    root = Path(__file__).resolve().parents[1]
    code = (
        "from pathlib import Path\n"
        "from cudavolumerenderer_tpu_torch.utils import native\n"
        f"native.BUILD_DIR = Path({str(tmp_path)!r})\n"
        "native.load()\n"
        "print(native.build_seconds > 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(root))
    procs = [subprocess.Popen([sys.executable, "-c", code], env=env,
                              stdout=subprocess.PIPE, text=True)
             for _ in range(3)]
    outs = [p.communicate(timeout=240)[0].split() for p in procs]
    assert [p.returncode for p in procs] == [0, 0, 0]
    assert sorted(o[-1] for o in outs) == ["False", "False", "True"]
    assert len(list(tmp_path.glob("libcvr_native-*.so"))) == 1
    assert not list(tmp_path.glob("*.tmp"))
