"""BASELINE config 3 (the hetvol .vdb at 1024^2): how its workload differs
from thesis Table 6.2's smoke row, and a sweep of its knobs.

Port of benchmarks/micro_config3.py, with its flags, its rows (`rows`),
its JSON keys (the derivation block included) and its timing protocol.
Config 3's scene is the smoke grid (128x128x50, albedo 0.9 d) written as a
real .vdb archive (baseline_configs.write_hetvol_vdb) and read through
the native reader (scene/vdb.load_vdb_scene, utils/native.py's g++
library): scale 100 on the unit box.  The rows:

  1. f_res = Mrays/s at 1024^2 over Mrays/s at 400^2 on that scene;
  2. f_scale = Mrays/s at scale 100 over scale 800 at 400^2 on the same
     grid;
  3. a sweep at 1024^2: q4 tables, min_width 64, cascade 1.5,
     single-level.

Per row reps + 1 renders of fast.render_tile at seeds 501, 502, ..., each
timed on the host clock and fenced by the image sum, rep 0 discarded, the
fastest kept.  --quick renders 64^2 and 128^2 instead of 400^2 and 1024^2.

    python -m cudavolumerenderer_tpu_torch.benchmarks.micro_config3 \\
        [--platform cuda|cpu] [--reps 3] [--spp 4] [--only SUBSTR ...] \\
        [--quick] [--out path]

The scene file goes to a temporary directory.  The JSON is {row: {"s",
"mrays_s", "res", "precision", "n_rays", counts}, "derivation": {...}};
it is written only to --out (the JAX script writes
benchmarks/results_config3.json by default).
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time

import torch

from ..cli import device_of
from ..models import fast
from ..scene.types import Medium, RenderSettings, Scene
from ..scene.vdb import load_vdb_scene
from . import scene_classes as sc
from .baseline_configs import write_hetvol_vdb

#: thesis Table 6.2's streamingSK (400^2, scale 800; GT 650M), Mrays/s
REFERENCE_BAR = 17.41
#: the keys main's result holds, by mode (its flags): the JAX script's JSON
#: keys
KEYS = {"": {"s", "mrays_s", "res", "precision", "derivation", "f_res",
             "f_scale_100_over_800", "best_1024", "reference_bar",
             "note", "vs_reference_bar"}}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m cudavolumerenderer_tpu_torch.benchmarks.micro_config3")
    ap.add_argument("--platform", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--spp", type=int, default=4)
    ap.add_argument("--out", default=None, help="write the JSON here")
    ap.add_argument("--only", nargs="*", default=None)
    ap.add_argument("--quick", action="store_true",
                    help="tiny resolutions (CPU smoke test)")
    return ap.parse_args(argv)


def with_scale(scene: Scene, scale: float) -> Scene:
    """The same scene with the medium's density scale replaced (the JAX
    script's medium._replace(scale=...)); the affine albedo fit stays."""
    m = scene.medium
    medium = Medium(m.density, m.albedo, m.box_min, m.box_max,
                    torch.tensor(scale, dtype=torch.float32,
                                 device=scene.device),
                    m.max_density, m.g, albedo_affine=m.albedo_affine)
    return Scene(medium, scene.bsdf, scene.le)


def rows(scene, scene800, r_lo: int, r_hi: int) -> list:
    """(name, scene, res, render_tile keywords): micro_config3.py's rows."""
    base = dict(two_level=True, cascade_factor=2)
    return [
        ("s100_400_base", scene, r_lo, dict(**base)),
        ("s100_1024_base", scene, r_hi, dict(**base)),
        ("s800_400_base", scene800, r_lo, dict(**base)),
        ("s100_1024_q4", scene, r_hi, dict(**base, table_bits=4)),
        ("s100_1024_q4_minw64", scene, r_hi,
         dict(**base, table_bits=4, min_width=64)),
        ("s100_1024_q4_f15", scene, r_hi,
         dict(two_level=True, cascade_factor=1.5, table_bits=4)),
        ("s100_1024_1l", scene, r_hi, dict(two_level=False)),
        ("s100_1024_1l_q4", scene, r_hi, dict(two_level=False, table_bits=4)),
    ]


def config_row(sc_, res: int, spp: int, reps: int, name: str,
               kw: dict) -> dict:
    settings = RenderSettings.from_flags(True)
    kw = sc.gated_bits(kw, settings)
    camera = sc.camera(res, sc_.device)
    off = torch.zeros(2, dtype=torch.float32, device=sc_.device)
    times, rays, seed = [], 0.0, 500
    with sc.RowCounts("fastbody") as rc:
        for rep in range(reps + 1):
            seed += 1
            t0 = time.time()
            img, nr = fast.render_tile(sc_, camera, settings, (res, res), off,
                                       (res, res), spp, seed, 0, **kw)
            s = float(img.sum())
            dt = time.time() - t0
            rays = float(nr)
            if rep:
                times.append(dt)
            print(f"{name} rep{rep}: {dt:.3f}s "
                  f"{rays / (dt * 1e6):.2f} Mrays/s (sum {s:.1f})", flush=True)
    best = min(times)
    return {"s": best, "mrays_s": rays / best / 1e6, "res": res,
            "precision": (f"reduced-q{kw['table_bits']}"
                          if kw["table_bits"] < 32 else "full-f32"),
            "times_s": times, "n_rays": rays, **rc.counts}


def derivation(results: dict) -> dict:
    d = {}
    if "s100_400_base" in results and "s100_1024_base" in results:
        d["f_res"] = (results["s100_1024_base"]["mrays_s"]
                      / results["s100_400_base"]["mrays_s"])
    if "s100_400_base" in results and "s800_400_base" in results:
        d["f_scale_100_over_800"] = (results["s100_400_base"]["mrays_s"]
                                     / results["s800_400_base"]["mrays_s"])
    best1024 = max((v["mrays_s"] for k, v in results.items() if "1024" in k),
                   default=None)
    d["best_1024"] = best1024
    d["reference_bar"] = REFERENCE_BAR
    d["note"] = (
        "bar = thesis T6.2 streamingSK 17.41 (400^2, scale 800) held "
        "resolution-neutral; f_res/f_scale decompose how the config-3 "
        "workload differs from that row on our own kernels")
    if best1024 is not None:
        d["vs_reference_bar"] = best1024 / REFERENCE_BAR
    return d


def main(argv=None) -> dict:
    args = parse_args(argv)
    dev = device_of(args.platform)
    with tempfile.TemporaryDirectory() as tmp:
        scene, _ = load_vdb_scene(write_hetvol_vdb(tmp), device=dev)
    scene800 = with_scale(scene, 800.0)
    r_lo, r_hi = (64, 128) if args.quick else (400, 1024)
    selected = rows(scene, scene800, r_lo, r_hi)
    if args.only:
        selected = [r for r in selected if any(s in r[0] for s in args.only)]
    results = {}
    for name, sc_, res, kw in selected:
        results[name] = config_row(sc_, res, args.spp, args.reps, name, kw)
        if args.out:
            with open(args.out, "w") as f:
                json.dump(results, f, indent=1)
    results["derivation"] = derivation(results)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    print(json.dumps(results["derivation"], indent=1))
    return results


if __name__ == "__main__":
    main()
    sys.exit(0)
