"""Ablation: how much of the medical class's cost is the GGX boundary and
Russian roulette, against the tracking itself.

Port of benchmarks/micro_ablate.py: its medical stand-in (scene_classes'
medical_blobs: the 40-blob field on 256^3 without medical_volume's
smoothstep, albedo (d, 0.5, 1 - d), scale 100, at 512^2 x 4) through
fast.render_tile two-level with with_stats, for each of bsdf ggx / null
and RR on / off; one render at seed 1 to warm up, one timed at seed 77 (perf_counter, fenced by the image sum).  The
last stage drains each lane to its end in one launch on the card, so its
longest lane (`longest_lane`, the drain's L; None on the CPU) is recorded
beside the wall: with RR off a path runs up to max_path_length bounces.

--regen-levels instead times regenerationSK at the three refill
granularities (refill_group 1, 8 and 1,024 lanes: thread, warp and block,
the REGENERATION_SYNCHRONIZATION_LEVEL axis of thesis Tables 4.3-4.4) on
the bucky class at 256^2 x 20 with n_lanes 2^16: 4 reps at seeds 100-103,
rep 0 discarded, Mrays/s from the fastest.

    python -m cudavolumerenderer_tpu_torch.benchmarks.micro_ablate \\
        [--platform cuda|cpu] [--regen-levels]

Returns (and prints as JSON) {"bsdf=<b> rr=<0|1>": {"time", "mrays_s",
"rows_s", "rays", "longest_lane", counts}} or, with --regen-levels,
{"refill_group=<g>": {"times_s", "mrays_s", "rays", counts}}; the JAX
script only prints.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from ..cli import device_of
from ..models import fast, regeneration
from ..ops import fastbody
from ..scene.types import RenderSettings
from . import scene_classes as sc

GROUPS = (1, 8, 1024)
REGEN_REPS = 4
REGEN_LANES = 1 << 16
#: the keys main's result holds, by mode (its flags): what the JAX script
#: prints, under the port's names (the script writes no JSON)
KEYS = {"": {"time", "mrays_s", "rows_s", "longest_lane"},
        "--regen-levels": {"times_s", "mrays_s"}}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m cudavolumerenderer_tpu_torch.benchmarks.micro_ablate")
    ap.add_argument("--platform", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--regen-levels", action="store_true")
    return ap.parse_args(argv)


def regen_row(scene, camera, res: int, spp: int, group: int) -> dict:
    settings = RenderSettings.from_flags(True)
    off = torch.zeros(2, dtype=torch.float32, device=scene.device)
    times, rays = [], 0.0
    with sc.RowCounts("familybody") as rc:
        for rep in range(REGEN_REPS):
            t0 = time.perf_counter()
            img, nr = regeneration.render_tile(
                scene, camera, settings, (res, res), off, (res, res), spp,
                100 + rep, 0, n_lanes=REGEN_LANES, refill_group=group)
            rays = float(nr)
            _ = float(img.sum())
            dt = time.perf_counter() - t0
            if rep > 0:
                times.append(dt)
    return {"times_s": times, "mrays_s": rays / min(times) / 1e6,
            "rays": rays, **rc.counts}


def regen_levels(dev) -> dict:
    scene = sc.scene("bucky", dev)
    res, spp = sc.size("bucky")
    camera = sc.camera(res, dev)
    results = {}
    for group in GROUPS:
        r = regen_row(scene, camera, res, spp, group)
        results[f"refill_group={group}"] = r
        print(f"refill_group={group:5d}  {[round(t, 2) for t in r['times_s']]}"
              f" s -> {r['mrays_s']:6.2f} Mrays/s", flush=True)
    return results


def ablate_row(scene, camera, res: int, iters: int, bsdf: str,
               rr: bool) -> dict:
    settings = RenderSettings.from_flags(True, bsdf_kind=bsdf,
                                         russian_roulette=rr)
    args = dict(scene=scene, camera=camera, settings=settings,
                tile_dim=(res, res),
                tile_offset=torch.zeros(2, dtype=torch.float32,
                                        device=scene.device),
                full_resolution=(res, res), spp=iters, two_level=True,
                with_stats=True)
    with sc.RowCounts("fastbody") as rc:
        out = fast.render_tile(seed=1, path_id_base=0, **args)
        _ = float(out[0].sum())
        t0 = time.perf_counter()
        out = fast.render_tile(seed=77, path_id_base=0, **args)
        _ = float(out[0].sum())
        dt = time.perf_counter() - t0
    drain = fastbody.KERNEL.last_drain
    n_rays, rows = float(out[1]), float(out[2])
    return {"time": dt, "mrays_s": n_rays / dt / 1e6, "rows_s": rows / dt / 1e6,
            "rays": n_rays, "longest_lane": drain["L"] if drain else None,
            **rc.counts}


def main(argv=None) -> dict:
    args = parse_args(argv)
    dev = device_of(args.platform)
    if args.regen_levels:
        results = regen_levels(dev)
    else:
        scene = sc.scene("medical_blobs", dev)
        res, iters = sc.size("medical_blobs")
        camera = sc.camera(res, dev)
        results = {}
        for bsdf in ("ggx", "null"):
            for rr in (True, False):
                r = ablate_row(scene, camera, res, iters, bsdf, rr)
                results[f"bsdf={bsdf} rr={int(rr)}"] = r
                print(f"bsdf={bsdf:4s} rr={int(rr)} time={r['time']:7.3f}s "
                      f"Mrays/s={r['mrays_s']:6.2f} "
                      f"rows/s={r['rows_s']:6.1f}M "
                      f"longest lane={r['longest_lane']}", flush=True)
    print(json.dumps(results, indent=1), flush=True)
    return results


if __name__ == "__main__":
    main()
    sys.exit(0)
