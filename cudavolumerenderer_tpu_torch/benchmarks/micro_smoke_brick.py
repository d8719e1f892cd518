"""brickSK on its natural class, high optical depth (smoke at scale 800),
over k_steps, against fastSK two-level.

Port of benchmarks/micro_smoke_brick.py, with its flags, rows, JSON keys
and timing protocol: the smoke class (scene_classes.py, 128x128x50, albedo
0.9 d, scale 800) at --res^2 x --spp through fast.render_tile two-level
and brick.render_tile at each --k (k_steps: tracking steps per round);
per row reps + 1 renders at seeds 100, 101, ..., each timed by
perf_counter and fenced by reading n_rays and the image sum, rep 0
discarded, Mrays/s from the fastest.

    python -m cudavolumerenderer_tpu_torch.benchmarks.micro_smoke_brick \\
        [--platform cuda|cpu] [--res 400] [--spp 4] [--reps 3] \\
        [--k 8 32 64 128] [--out path]

The JSON is {row: {"times_s", "mrays_per_s", "n_rays", counts}}; it is
written only to --out (the JAX script writes
benchmarks/results_smoke_brick.json by default).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from ..cli import device_of
from ..models import brick, fast
from ..scene.types import RenderSettings
from . import scene_classes as sc
#: the keys main's result holds, by mode (its flags): the JAX script's JSON
#: keys
KEYS = {"": {"times_s", "mrays_per_s"}}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m cudavolumerenderer_tpu_torch.benchmarks."
        "micro_smoke_brick")
    ap.add_argument("--platform", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--res", type=int, default=400)
    ap.add_argument("--spp", type=int, default=4)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--k", type=int, nargs="+", default=[8, 32, 64, 128])
    ap.add_argument("--out", default=None, help="write the JSON here")
    return ap.parse_args(argv)


def timed(fn, common: tuple, reps: int, label: str, kernel: str,
          **kw) -> dict:
    times, rays = [], 0.0
    with sc.RowCounts(kernel) as rc:
        for rep in range(reps + 1):
            t0 = time.perf_counter()
            img, nr = fn(*common, 100 + rep, 0, **kw)
            rays = float(nr)
            _ = float(img.sum())
            dt = time.perf_counter() - t0
            if rep > 0:
                times.append(dt)
    mrays = rays / min(times) / 1e6
    print(f"{label:24s} {[round(t, 2) for t in times]} s"
          f" -> {mrays:6.2f} Mrays/s", flush=True)
    return {"times_s": times, "mrays_per_s": mrays, "n_rays": rays,
            **rc.counts}


def main(argv=None) -> dict:
    args = parse_args(argv)
    dev = device_of(args.platform)
    scene = sc.scene("smoke", dev)
    res = args.res
    common = (scene, sc.camera(res, dev), RenderSettings.from_flags(True),
              (res, res), torch.zeros(2, dtype=torch.float32, device=dev),
              (res, res), args.spp)
    results = {"fastSK-2L": timed(fast.render_tile, common, args.reps,
                                  "fastSK-2L", "fastbody", two_level=True)}
    for k in args.k:
        results[f"brickSK k={k}"] = timed(brick.render_tile, common,
                                          args.reps, f"brickSK k={k}",
                                          "brickbody", k_steps=k)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=2)
    return results


if __name__ == "__main__":
    main()
    sys.exit(0)
