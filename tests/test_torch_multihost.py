"""The port's multi-process entry point
(cudavolumerenderer_tpu_torch/scripts/run_multihost.py) on the CPU: two
gloo processes against one, as tests/test_multihost.py runs the JAX
script.  Path ids are keyed by (seed, path id), so the image must not
depend on how the samples are split across processes; the only
difference is the order of the float32 sum over ranks.  Also the
scaling benchmark (benchmarks/scaling_efficiency.py) over two ranks."""

import json
import os
import socket
import subprocess
import sys

import numpy as np

from cudavolumerenderer_tpu_torch.scene import procedural
from cudavolumerenderer_tpu_torch.config import Config
from cudavolumerenderer_tpu_torch.scene.loader import load_scene
from cudavolumerenderer_tpu_torch.utils.image import load_hdr, save_hdr

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODULE = "cudavolumerenderer_tpu_torch.scripts.run_multihost"
SCALING = "cudavolumerenderer_tpu_torch.benchmarks.scaling_efficiency"
TIMEOUT = 300  # seconds for one process


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run(tmp_path, argv, nproc=1, module=MODULE):
    """Start nproc ranks of `module` (a --coordinator group when
    nproc > 1) and return rank 0's output; every rank must exit 0."""
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    group = []
    if nproc > 1:
        group = ["--coordinator", f"127.0.0.1:{_free_port()}",
                 "--num-processes", str(nproc)]
    procs = [subprocess.Popen(
        [sys.executable, "-m", module, *argv, "--platform", "cpu", *group,
         *(["--process-id", str(pid)] if nproc > 1 else [])],
        env=env, cwd=str(tmp_path), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT,
    ) for pid in range(nproc)]
    try:
        logs = [p.communicate(timeout=TIMEOUT)[0].decode() for p in procs]
    finally:
        for p in procs:
            p.kill()
            p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    return logs[0]


def rays(log: str) -> int:
    """The ray count of the script's 'rendered ...' line."""
    line = next(x for x in log.splitlines() if x.startswith("rendered"))
    return int(line.split(", ")[1].split()[0])


def test_two_process_render_matches_single_process(tmp_path):
    raw = str(tmp_path / "blob.raw")
    procedural.write_raw_uchar(raw, procedural.blob_volume())
    out2, out1 = str(tmp_path / "two"), str(tmp_path / "one")
    log = _run(tmp_path, [raw, "-r", "32", "-i", "4", "-o", out2], nproc=2)
    assert "rendered 4 spp on 2 devices" in log
    log1 = _run(tmp_path, [raw, "-r", "32", "-i", "4", "-o", out1])
    assert "rendered 4 spp on 1 devices" in log1
    assert rays(log) == rays(log1) > 0
    a, b = load_hdr(out2 + ".hdr"), load_hdr(out1 + ".hdr")
    assert a.shape == (32, 32, 3) and np.isfinite(a).all() and a.mean() > 0
    np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)


def test_two_process_inverse_writes_recovered_density(tmp_path):
    """--inverse on a tiny target (8^2): two steps over two ranks write
    the recovered density grid (the scene's shape, finite, moved from the
    starting half density)."""
    raw = str(tmp_path / "blob.raw")
    procedural.write_raw_uchar(raw, procedural.blob_volume())
    target = str(tmp_path / "target.hdr")
    save_hdr(target, np.full((8, 8, 3), 0.3, np.float32))
    out = str(tmp_path / "inv")
    log = _run(tmp_path, [raw, "-r", "8", "-i", "2", "-o", out, "--inverse",
                          target, "--steps", "2"], nproc=2)
    assert "step 0: loss" in log and "_recovered.npz" in log
    rec = np.load(out + "_recovered.npz")["density"]
    scene, _ = load_scene(Config(scene_file=raw), device="cpu")
    start = scene.medium.density.data.numpy() * 0.5
    assert rec.shape == start.shape and np.isfinite(rec).all()
    assert np.abs(rec - start).max() > 0


def test_scaling_benchmark_rows_on_two_cpu_ranks(tmp_path):
    """benchmarks/scaling_efficiency over a 2-rank gloo group: rows for
    n = 1 and 2 with the JAX script's keys, the N = 1 row's efficiency 1
    and the plain comparison."""
    out = str(tmp_path / "scaling.json")
    _run(tmp_path, ["--res", "8", "--reps", "1", "--compare-plain",
                    "--json-out", out], nproc=2, module=SCALING)
    with open(out) as f:
        res = json.load(f)
    assert res["platform"] == "cpu" and res["n_devices"] == 2
    assert [r["n"] for r in res["rows"]] == [1, 2]
    assert [r["spp"] for r in res["rows"]] == [4, 8]
    assert res["rows"][0]["efficiency"] == 1.0
    for r in res["rows"]:
        assert r["s"] > 0 and r["rays_per_s"] > 0
    assert set(res["plain_comparison"]) == {
        "plain_s", "sharded_n1_s", "sharded_dispatch_overhead"}
