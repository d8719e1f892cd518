"""The bucky class's fastSK sweep: min_width, fractional cascade factors,
single-level and q4 tables.

Port of benchmarks/micro_bucky_r5.py, with its flags, its rows (`SWEEP`),
its JSON keys and its timing protocol: the bucky class (scene_classes.py,
32^3, the RAW transfer-function albedo) at --res^2 x --spp through
fast.render_tile (two-level unless the row says 1L); per row reps + 1
renders at seeds 100, 101, ..., each timed on the host clock and fenced by
the image sum, rep 0 discarded, Mrays/s from the mean of the rest.  Table
bits go through the production gate (Config.effective_table_bits).

    python -m cudavolumerenderer_tpu_torch.benchmarks.micro_bucky_r5 \\
        [--platform cuda|cpu] [--res 256] [--spp 20] [--reps 3] \\
        [--only SUBSTR ...] [--out path]

The JSON is {row: {"times_s", "mrays_per_s", "precision", "n_rays",
counts}}; it is written only to --out (the JAX script writes
benchmarks/results_bucky_r5.json by default).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from ..cli import device_of
from ..config import Config
from ..models import fast
from ..scene.types import RenderSettings
from . import scene_classes as sc

#: (row name, render_tile keywords; two_level_off and table_bits are
#: taken out first): micro_bucky_r5.py's sweep
SWEEP = [
    ("default(minw128,f2)", dict()),
    ("minw64", dict(min_width=64)),
    ("minw64+f125", dict(min_width=64, cascade_factor=1.25)),
    ("minw64+f15", dict(min_width=64, cascade_factor=1.5)),
    ("f125", dict(cascade_factor=1.25)),
    ("1L", dict(two_level_off=True)),
    ("minw64+q4", dict(min_width=64, table_bits=4)),
]
#: the keys main's result holds, by mode (its flags): the JAX script's JSON
#: keys
KEYS = {"": {"times_s", "mrays_per_s", "precision"}}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m cudavolumerenderer_tpu_torch.benchmarks.micro_bucky_r5")
    ap.add_argument("--platform", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--res", type=int, default=256)
    ap.add_argument("--spp", type=int, default=20)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--only", nargs="*", default=None)
    ap.add_argument("--out", default=None, help="write the JSON here")
    return ap.parse_args(argv)


def sweep_row(scene, camera, res: int, spp: int, reps: int, name: str,
              kw: dict) -> dict:
    settings = RenderSettings.from_flags(True)
    kw = dict(kw)
    two_level = not kw.pop("two_level_off", False)
    tb = kw.pop("table_bits", 32)
    cfg = Config(table_bits=tb, allow_quantized=(tb < 32), settings=settings)
    off = torch.zeros(2, dtype=torch.float32, device=scene.device)
    times = []
    with sc.RowCounts("fastbody") as rc:
        for rep in range(reps + 1):
            t0 = time.time()
            out = fast.render_tile(scene, camera, settings, (res, res), off,
                                   (res, res), spp, 100 + rep, 0,
                                   two_level=two_level,
                                   table_bits=cfg.effective_table_bits, **kw)
            img, n_rays = out[0], out[1]
            csum = float(img.sum())
            dt = time.time() - t0
            nr = float(n_rays)
            if rep:
                times.append(dt)
            print(f"  {name} rep{rep}: {dt:.3f}s ({nr / dt / 1e6:.2f} "
                  f"Mrays/s, csum {csum:.1f})", flush=True)
    return {"times_s": times, "mrays_per_s": nr / np.mean(times) / 1e6,
            "precision": "reduced-q4" if tb < 32 else "f32", "n_rays": nr,
            **rc.counts}


def main(argv=None) -> dict:
    args = parse_args(argv)
    dev = device_of(args.platform)
    scene = sc.scene("bucky", dev)
    res = args.res
    camera = sc.camera(res, dev)
    sweep = SWEEP
    if args.only:
        sweep = [(k, kw) for k, kw in sweep
                 if any(s in k for s in args.only)]
        print(f"--only: {[k for k, _ in sweep]}", flush=True)
    results = {}
    for name, kw in sweep:
        results[name] = sweep_row(scene, camera, res, args.spp, args.reps,
                                  name, kw)
        print(f"{name:24s} -> {results[name]['mrays_per_s']:.2f} Mrays/s",
              flush=True)
        if args.out:
            with open(args.out, "w") as f:
                json.dump(results, f, indent=2)
    return results


if __name__ == "__main__":
    main()
    sys.exit(0)
