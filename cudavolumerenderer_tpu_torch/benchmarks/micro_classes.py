"""Per-class fastSK-2L timings (bucky / smoke / medical) with per-rep
prints and host-readback fences: the scoreboard protocol.

Port of benchmarks/micro_classes.py: per class (scene_classes.py, at its
published size) fast.render_tile two-level at the default cascade factor 4
and at cascade_factor 2; one render to warm up (fenced by the image sum),
then 3 timed reps at fresh seeds, each fenced by reading the image sum and
n_rays to the host.  Prints whether the class's albedo is affine in
density (`albedo_affine`, which gates the tail kernel).

    python -m cudavolumerenderer_tpu_torch.benchmarks.micro_classes \\
        [--platform cuda|cpu] [bucky] [smoke] [medical]

Returns (and prints as JSON) {class: {"albedo_affine": bool, label:
{"times_s": [...], "mrays_per_s": [...], "sums": [...], "n_rays", counts}}}
with the labels "casc=4" and "casc=2"; the JAX script only prints.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from ..cli import device_of
from ..models import fast
from ..scene.types import RenderSettings
from . import scene_classes as sc

NAMES = ("bucky", "smoke", "medical")
LABELS = (("casc=4", {}), ("casc=2", {"cascade_factor": 2}))
REPS = 3
#: the keys main's result holds, by mode (its flags): what the JAX script
#: prints, under the port's names (the script writes no JSON)
KEYS = {"": {"albedo_affine", "casc=4", "casc=2"}}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m cudavolumerenderer_tpu_torch.benchmarks.micro_classes")
    ap.add_argument("--platform", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("which", nargs="*", help="classes (default: all three)")
    args = ap.parse_args(argv)
    for name in args.which:
        if name not in NAMES:
            ap.error(f"no class {name!r}; choose from {', '.join(NAMES)}")
    return args


def render(scene, camera, res: int, iters: int, seed: int, **kw):
    off = torch.zeros(2, dtype=torch.float32, device=scene.device)
    return fast.render_tile(scene, camera, RenderSettings.from_flags(True),
                            (res, res), off, (res, res), iters, seed, 0,
                            two_level=True, **kw)


def class_rows(name: str, dev) -> dict:
    """The class's rows: a warm-up and REPS timed renders per label."""
    scene = sc.scene(name, dev)
    res, iters = sc.size(name)
    affine = scene.medium.albedo_affine is not None
    print(f"{name}: affine={affine}", flush=True)
    camera = sc.camera(res, dev)
    out = {"albedo_affine": affine}
    seed = 700
    for label, kw in LABELS:
        row = {"times_s": [], "mrays_per_s": [], "sums": []}
        with sc.RowCounts("fastbody") as rc:
            img, nr = render(scene, camera, res, iters, seed, **kw)
            float(img.sum())  # warm-up + fence
            for rep in range(REPS):
                seed += 1
                t0 = time.time()
                img, nr = render(scene, camera, res, iters, seed, **kw)
                s = float(img.sum()) + float(nr)
                dt = time.time() - t0
                row["times_s"].append(dt)
                row["mrays_per_s"].append(float(nr) / (dt * 1e6))
                row["sums"].append(s)
                print(f"{name} {res}^2x{iters} {label} rep={rep}: {dt:.3f}s"
                      f"  {float(nr) / (dt * 1e6):.2f} Mrays/s"
                      f"  (sum {s:.1f})", flush=True)
        row["n_rays"] = float(nr)
        row.update(rc.counts)
        out[label] = row
    return out


def main(argv=None) -> dict:
    args = parse_args(argv)
    dev = device_of(args.platform)
    results = {name: class_rows(name, dev) for name in (args.which or NAMES)}
    print(json.dumps(results, indent=1), flush=True)
    return results


if __name__ == "__main__":
    main()
    sys.exit(0)
