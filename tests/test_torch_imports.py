"""The torch port imports no JAX: every module of the package, and
chip_smoke.py, import in a fresh interpreter without pulling in jax."""

import os
import pkgutil
import subprocess
import sys

import cudavolumerenderer_tpu_torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def port_modules():
    pkg = cudavolumerenderer_tpu_torch
    return [pkg.__name__] + [
        m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")
    ]


def test_every_module_imports_without_jax():
    mods = port_modules()
    assert "cudavolumerenderer_tpu_torch.models.fast" in mods
    assert "cudavolumerenderer_tpu_torch.ops.tailpk" in mods
    for name in ("ops.tracking", "models.brick", "cli", "utils.image",
                 "scene.vol", "scene.xml_builder", "scene.raw_builder",
                 "ops.pgather", "benchmarks.micro_pgather", "ops.woodcock",
                 "ops.gradient", "ops.morton", "models.naive",
                 "models.regeneration", "models.streaming",
                 "models.wavefront_mk", "models.fastq",
                 "models.differentiable", "models.inverse",
                 "benchmarks.inverse_256", "convert", "utils.native",
                 "scene.vdb", "ops.camera_controller", "utils.profiling",
                 "benchmarks.baseline_configs", "parallel.mesh",
                 "parallel.shard", "scripts.run_multihost",
                 "benchmarks.scaling_efficiency", "ops.fastbody",
                 "benchmarks.scene_classes", "benchmarks.run_suite",
                 "benchmarks.micro_classes", "benchmarks.micro_stats",
                 "benchmarks.micro_ablate", "benchmarks.micro_driver_overhead",
                 "benchmarks.micro_medical", "benchmarks.micro_medical2",
                 "benchmarks.micro_smoke2", "benchmarks.micro_bucky_r5",
                 "benchmarks.micro_config3", "benchmarks.micro_smoke_brick"):
        assert f"cudavolumerenderer_tpu_torch.{name}" in mods
    code = (
        "import importlib, sys\n"
        f"for m in {mods + ['chip_smoke']!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules\n"
        "             if k in ('jax', 'cudavolumerenderer_tpu')\n"
        "             or k.startswith(('jax.', 'jaxlib',\n"
        "                              'cudavolumerenderer_tpu.')))\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
