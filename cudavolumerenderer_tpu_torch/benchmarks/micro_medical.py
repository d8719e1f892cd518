"""Medical-class (256^3 at 512^2 x 4) fastSK timing over lanes_per_pixel.

Port of benchmarks/micro_medical.py: fast.render_tile two-level on the
medical class (scene_classes.py) for each lanes_per_pixel m (default 1, 2
and 4): one render at seed 1000 to warm up (fenced by the image sum), then
3 timed reps at seeds 1001-1003, each fenced by reading the image sum and
n_rays to the host.

    python -m cudavolumerenderer_tpu_torch.benchmarks.micro_medical \\
        [--platform cuda|cpu] [m ...]

Returns (and prints as JSON) {"albedo_affine": bool, "m=<m>": {"times_s",
"mrays_s", "sums", "n_rays", counts}}; the JAX script only prints.
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

REPS = 3
#: the keys main's result holds, by mode (its flags): what the JAX script
#: prints, under the port's names (the script writes no JSON)
KEYS = {"": {"albedo_affine", "m=1", "m=2", "m=4"}}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m cudavolumerenderer_tpu_torch.benchmarks.micro_medical")
    ap.add_argument("--platform", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("m", nargs="*", type=int,
                    help="lanes_per_pixel values (default 1 2 4)")
    return ap.parse_args(argv)


def m_row(scene, camera, res: int, iters: int, m: int):
    settings = RenderSettings.from_flags(True)
    off = torch.zeros(2, dtype=torch.float32, device=scene.device)

    def render(seed):
        return fast.render_tile(scene, camera, settings, (res, res), off,
                                (res, res), iters, seed, 0,
                                lanes_per_pixel=m, two_level=True)

    seed = 1000
    row = {"times_s": [], "mrays_s": [], "sums": []}
    with sc.RowCounts("fastbody") as rc:
        img, nr = render(seed)
        float(img.sum())  # warm-up + fence
        for rep in range(REPS):
            seed += 1
            t0 = time.time()
            img, nr = render(seed)
            s = float(img.sum()) + float(nr)  # host readback fence
            dt = time.time() - t0
            row["times_s"].append(dt)
            row["mrays_s"].append(float(nr) / (dt * 1e6))
            row["sums"].append(s)
            print(f"m={m} rep={rep}: {dt:.3f}s  "
                  f"{float(nr) / (dt * 1e6):.2f} Mrays/s  (sum {s:.1f})",
                  flush=True)
    return {**row, "n_rays": float(nr), **rc.counts}


def main(argv=None) -> dict:
    args = parse_args(argv)
    dev = device_of(args.platform)
    scene = sc.scene("medical", dev)
    affine = scene.medium.albedo_affine is not None
    print("albedo_affine:", affine)
    res, iters = sc.size("medical")
    camera = sc.camera(res, dev)
    results = {"albedo_affine": affine}
    for m in args.m or [1, 2, 4]:
        results[f"m={m}"] = m_row(scene, camera, res, iters, m)
    print(json.dumps(results, indent=1), flush=True)
    return results


if __name__ == "__main__":
    main()
    sys.exit(0)
