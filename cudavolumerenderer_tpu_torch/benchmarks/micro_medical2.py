"""The medical class's fastSK sweep: bricks, min_width, packed tables,
the speculative and single-level tails, the tail kernel's width and steps,
and fractional cascade factors.

Port of benchmarks/micro_medical2.py, with its flags, its sweep (`SWEEP`,
row for row), its JSON keys and its timing protocol: the medical class
(scene_classes.py, 256^3 at scale 100) at --res^2 x --spp through
fast.render_tile two-level; per row reps + 1 renders at seeds 100, 101,
..., each timed by perf_counter and fenced by reading n_rays and the image
sum to the host, rep 0 discarded, Mrays/s from the fastest.  Table bits go
through the production gate (Config.effective_table_bits with
allow_quantized), and quantized rows are labelled reduced-precision.
Unless --no-stats, one with_stats render at the champion knobs (512
bricks, min_width 64, q4, cascade 2) prints the busy fraction and each
stage's rows first.

    python -m cudavolumerenderer_tpu_torch.benchmarks.micro_medical2 \\
        [--platform cuda|cpu] [--res 512] [--spp 4] [--reps 3] \\
        [--only SUBSTR ...] [--no-stats] [--out path]

Each row also carries n_rays and the kernels' counts over its renders
(scene_classes.RowCounts).  The JSON is written only to --out (the JAX
script writes benchmarks/results_medical2.json by default).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from ..cli import device_of
from ..models import fast
from ..scene.types import RenderSettings
from . import scene_classes as sc

_BASE = dict(cascade_factor=2)
#: (row name, render_tile keywords): micro_medical2.py's sweep
SWEEP = [
    ("bricks16", dict(**_BASE, max_bricks=4096)),
    ("bricks16+tb4", dict(**_BASE, max_bricks=4096, tail_bricks=4)),
    ("b16+spec8@512",
     dict(**_BASE, max_bricks=4096, min_width=512,
          tail_single_level=True, tail_spec=8, spec_width=512)),
    ("b16+spec16@512",
     dict(**_BASE, max_bricks=4096, min_width=512,
          tail_single_level=True, tail_spec=16, spec_width=512)),
    ("b16+spec32@512",
     dict(**_BASE, max_bricks=4096, min_width=512,
          tail_single_level=True, tail_spec=32, spec_width=512)),
    ("b16+spec16@2048",
     dict(**_BASE, max_bricks=4096, min_width=2048,
          tail_single_level=True, tail_spec=16, spec_width=2048)),
    ("b16+minw512", dict(**_BASE, max_bricks=4096, min_width=512)),
    ("b16+tailpk128",
     dict(**_BASE, max_bricks=4096, tail_pallas=True,
          tail_pk_width=128, tail_pk_steps=16)),
    ("b16+tailpk256",
     dict(**_BASE, max_bricks=4096, tail_pallas=True,
          tail_pk_width=256, tail_pk_steps=16)),
    ("b16+tailpk128s32",
     dict(**_BASE, max_bricks=4096, tail_pallas=True,
          tail_pk_width=128, tail_pk_steps=32)),
    ("b16+tailpk512",
     dict(**_BASE, max_bricks=4096, tail_pallas=True,
          tail_pk_width=512, tail_pk_steps=16)),
    ("b16+minw512+tailpk256",
     dict(**_BASE, max_bricks=4096, min_width=512,
          tail_pallas=True, tail_pk_width=256, tail_pk_steps=16)),
    ("b16+minw256", dict(**_BASE, max_bricks=4096, min_width=256)),
    ("b16+minw128", dict(**_BASE, max_bricks=4096, min_width=128)),
    ("b16+minw64", dict(**_BASE, max_bricks=4096, min_width=64)),
    ("b32+minw128", dict(**_BASE, max_bricks=32768, min_width=128)),
    ("b8+minw128", dict(**_BASE, max_bricks=512, min_width=128)),
    ("b8+minw128+tb4",
     dict(**_BASE, max_bricks=512, min_width=128, table_bits=4)),
    ("b8+minw128+tb8",
     dict(**_BASE, max_bricks=512, min_width=128, table_bits=8)),
    ("b16+minw128+tb4",
     dict(**_BASE, max_bricks=4096, min_width=128, table_bits=4)),
    ("b32+minw128+q4",
     dict(**_BASE, max_bricks=32768, min_width=128, table_bits=4)),
    ("b8+minw128+q4+m2",
     dict(**_BASE, max_bricks=512, min_width=128, table_bits=4,
          lanes_per_pixel=2)),
    ("b8+minw128+q4+casc3",
     dict(cascade_factor=3, max_bricks=512, min_width=128, table_bits=4)),
    ("b8+minw64+q4",
     dict(**_BASE, max_bricks=512, min_width=64, table_bits=4)),
    ("b32+minw64+qq4",
     dict(**_BASE, max_bricks=32768, min_width=64, table_bits=4)),
    ("b8+minw32+qq4",
     dict(**_BASE, max_bricks=512, min_width=32, table_bits=4)),
    ("b32+minw32+qq4",
     dict(**_BASE, max_bricks=32768, min_width=32, table_bits=4)),
    ("b128k+minw64+qq4",
     dict(**_BASE, max_bricks=131072, min_width=64, table_bits=4)),
    ("b8+minw64+q4+f15",
     dict(cascade_factor=1.5, max_bricks=512, min_width=64, table_bits=4)),
    ("b8+minw64+q4+f133",
     dict(cascade_factor=1.33, max_bricks=512, min_width=64, table_bits=4)),
    ("b8+minw64+q4+f125",
     dict(cascade_factor=1.25, max_bricks=512, min_width=64, table_bits=4)),
    ("b8+minw64+f15",
     dict(cascade_factor=1.5, max_bricks=512, min_width=64)),
    ("b8+minw64+q4+f120",
     dict(cascade_factor=1.2, max_bricks=512, min_width=64, table_bits=4)),
    ("b8+minw64+q4+f115",
     dict(cascade_factor=1.15, max_bricks=512, min_width=64, table_bits=4)),
    ("b8+minw64+q4+f110",
     dict(cascade_factor=1.1, max_bricks=512, min_width=64, table_bits=4)),
    ("b4+minw64+q4+f125",
     dict(cascade_factor=1.25, max_bricks=64, min_width=64, table_bits=4)),
    ("b16+minw64+q4+f125",
     dict(cascade_factor=1.25, max_bricks=4096, min_width=64, table_bits=4)),
]
#: the with_stats render's knobs (the champion: b8 + minw64 + q4)
STATS_KW = dict(max_bricks=512, min_width=64, table_bits=4, cascade_factor=2)
#: the keys main's result holds, by mode (its flags): the JAX script's JSON
#: keys
KEYS = {"": {"times_s", "mrays_per_s", "precision"}}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m cudavolumerenderer_tpu_torch.benchmarks.micro_medical2")
    ap.add_argument("--platform", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--res", type=int, default=512)
    ap.add_argument("--spp", type=int, default=4)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--out", default=None, help="write the JSON here")
    ap.add_argument(
        "--only", nargs="*", default=None,
        help="run only sweep configs whose name contains any of these "
        "substrings")
    ap.add_argument("--no-stats", action="store_true",
                    help="skip the with_stats diagnostic render")
    return ap.parse_args(argv)


def sweep_row(scene, camera, res: int, spp: int, reps: int, kw: dict) -> dict:
    """reps + 1 timed renders at seeds 100.., rep 0 discarded; counted."""
    settings = RenderSettings.from_flags(True)
    kw = sc.gated_bits(kw, settings)
    off = torch.zeros(2, dtype=torch.float32, device=scene.device)
    times, rays = [], 0.0
    tail = ("taildrain",) if kw.get("tail_pallas") else ()
    with sc.RowCounts("fastbody", *tail) as rc:
        for rep in range(reps + 1):
            t0 = time.perf_counter()
            img, nr = fast.render_tile(scene, camera, settings, (res, res),
                                       off, (res, res), spp, 100 + rep, 0,
                                       two_level=True, **kw)
            rays = float(nr)  # host readback = fence
            _ = float(img.sum())
            dt = time.perf_counter() - t0
            if rep > 0:  # discard the warm-up rep
                times.append(dt)
    best = min(times)
    return {
        "times_s": times, "mrays_per_s": rays / best / 1e6,
        "precision": (f"reduced-q{kw['table_bits']}"
                      if kw["table_bits"] < 32 else "full-f32"),
        "n_rays": rays, **rc.counts,
    }


def stats_render(scene, camera, res: int, spp: int) -> dict:
    out = fast.render_tile(scene, camera, RenderSettings.from_flags(True),
                           (res, res), torch.zeros(2, dtype=torch.float32,
                                                   device=scene.device),
                           (res, res), spp, 1, 0, two_level=True,
                           with_stats=True, **STATS_KW)
    n_rays, n_rows, n_busy = float(out[1]), float(out[2]), float(out[3])
    stage_rows = out[4].cpu().numpy()
    widths = fast._cascade_widths(res * res, 2, 64)
    print(f"stats(casc=2): rays={n_rays:.0f} rows={n_rows:.0f} "
          f"busy_frac={n_busy / max(n_rows, 1):.3f} "
          f"width_equiv_iters={n_rows / (res * res):.0f}", flush=True)
    for w, r in zip(widths, stage_rows):
        print(f"  stage width={w:7d}: rows={r:12.0f} iters={r / w:7.0f} "
              f"width_equiv={r / (res * res):6.1f}", flush=True)
    return {"rays": n_rays, "rows": n_rows, "busy_frac": n_busy / max(n_rows, 1),
            "stage_rows": [float(r) for r in np.asarray(stage_rows)]}


def main(argv=None) -> dict:
    args = parse_args(argv)
    dev = device_of(args.platform)
    scene = sc.scene("medical", dev)
    res = args.res
    camera = sc.camera(res, dev)
    if not args.no_stats:
        stats_render(scene, camera, res, args.spp)
    sweep = SWEEP
    if args.only:
        sweep = [(k, kw) for k, kw in sweep
                 if any(sub in k for sub in args.only)]
        print(f"--only: {[k for k, _ in sweep]}", flush=True)
    results = {}
    for key, kw in sweep:
        r = sweep_row(scene, camera, res, args.spp, args.reps, kw)
        results[key] = r
        print(f"{key:28s} {[round(t, 3) for t in r['times_s']]}"
              f" -> {r['mrays_per_s']:6.2f} Mrays/s", flush=True)
        if args.out:  # incremental, as the JAX script
            with open(args.out, "w") as f:
                json.dump(results, f, indent=2)
    return results


if __name__ == "__main__":
    main()
    sys.exit(0)
