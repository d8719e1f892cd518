"""The smoke class's fastSK sweep: brick size, cascade shape, lane packing,
the tail chain and packed tables.

Port of benchmarks/micro_smoke2.py, with its flags, its rows (`CONFIGS`),
its JSON keys and its timing protocol: the smoke class (scene_classes.py,
128x128x50 at scale 800, thesis Table 6.2's null-collision stress test) at
--res^2 x --spp through fast.render_tile two-level; per row reps + 1
renders at seeds 901, 902, ..., each timed on the host clock and fenced by
the image sum, rep 0 discarded, the fastest kept.  `brick_size` overrides
pick_brick's brick ((2, 2, 2) makes 64 x 64 x 25 bricks on this grid).
Table bits go through the production gate (Config.effective_table_bits
with allow_quantized).  Unless --no-stats, one with_stats render at
cascade 2 prints the busy fraction and each stage's evaluations first.

    python -m cudavolumerenderer_tpu_torch.benchmarks.micro_smoke2 \\
        [--platform cuda|cpu] [--res 400] [--spp 4] [--reps 3] \\
        [--only SUBSTR ...] [--no-stats] [--out path]

The JSON is {"res", "spp", "reference_best", "results": {row: {"s",
"mrays_s", "precision", "n_rays", counts}}}; it is written only to --out
(the JAX script writes benchmarks/results_smoke2.json by default).
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

_BASE = dict(cascade_factor=2)
#: (row name, render_tile keywords): micro_smoke2.py's rows
CONFIGS = [
    ("casc2", dict(**_BASE)),
    ("casc4", dict()),
    ("casc2+m2", dict(**_BASE, lanes_per_pixel=2)),
    ("casc2+b2", dict(**_BASE, brick_size=(2, 2, 2))),
    ("casc2+b224", dict(**_BASE, brick_size=(2, 2, 4))),
    ("casc2+b2+m2", dict(**_BASE, brick_size=(2, 2, 2), lanes_per_pixel=2)),
    ("casc2+b8", dict(**_BASE, brick_size=(8, 8, 8))),
    ("casc2+tb2", dict(**_BASE, tail_bricks=2)),
    ("casc2+chain16", dict(**_BASE, tail_chain=16)),
    ("casc2+minw512", dict(**_BASE, min_width=512)),
    ("casc3", dict(cascade_factor=3)),
    ("casc2+b2+tb2", dict(**_BASE, brick_size=(2, 2, 2), tail_bricks=2)),
    ("casc2+q4", dict(**_BASE, table_bits=4)),
    ("casc2+q8", dict(**_BASE, table_bits=8)),
    ("casc2+b2+q4", dict(**_BASE, brick_size=(2, 2, 2), table_bits=4)),
    ("casc2+q4+minw64", dict(**_BASE, table_bits=4, min_width=64)),
    ("f125+q4+minw64", dict(cascade_factor=1.25, table_bits=4, min_width=64)),
    ("f15+q4+minw64", dict(cascade_factor=1.5, table_bits=4, min_width=64)),
]
#: thesis Table 6.2's best smoke row (streamingSK, GT 650M), Mrays/s
REFERENCE_BEST = 17.41
#: the keys main's result holds, by mode (its flags): the JAX script's JSON
#: keys
KEYS = {"": {"res", "spp", "reference_best", "results", "s", "mrays_s",
             "precision"}}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m cudavolumerenderer_tpu_torch.benchmarks.micro_smoke2")
    ap.add_argument("--platform", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--res", type=int, default=400)
    ap.add_argument("--spp", type=int, default=4)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--out", default=None, help="write the JSON here")
    ap.add_argument("--only", nargs="*", default=None)
    ap.add_argument("--no-stats", action="store_true")
    return ap.parse_args(argv)


def common(scene, res: int, spp: int) -> dict:
    return dict(tile_dim=(res, res),
                tile_offset=torch.zeros(2, dtype=torch.float32,
                                        device=scene.device),
                full_resolution=(res, res), spp=spp, two_level=True)


def config_row(scene, camera, res: int, spp: int, reps: int, name: str,
               kw: dict) -> dict:
    settings = RenderSettings.from_flags(True)
    kw = sc.gated_bits(kw, settings)
    times, rays, seed = [], 0.0, 900
    with sc.RowCounts("fastbody") as rc:
        for rep in range(reps + 1):
            seed += 1
            t0 = time.time()
            img, nr = fast.render_tile(scene, camera, settings, seed=seed,
                                       path_id_base=0,
                                       **common(scene, res, spp), **kw)
            s = float(img.sum())
            dt = time.time() - t0
            rays = float(nr)
            if rep:
                times.append(dt)
            print(f"{name} rep{rep}: {dt:.3f}s "
                  f"{rays / (dt * 1e6):.2f} Mrays/s (sum {s:.1f})", flush=True)
    best = min(times)
    return {"s": best, "mrays_s": rays / best / 1e6,
            "precision": (f"reduced-q{kw['table_bits']}"
                          if kw["table_bits"] < 32 else "full-f32"),
            "times_s": times, "n_rays": rays, **rc.counts}


def stats_render(scene, camera, res: int, spp: int) -> None:
    out = fast.render_tile(scene, camera, RenderSettings.from_flags(True),
                           seed=1, path_id_base=0, with_stats=True,
                           cascade_factor=2, **common(scene, res, spp))
    _ = float(out[0].sum())  # host fence
    nr, n_rows, n_busy = float(out[1]), float(out[2]), float(out[3])
    stage_rows = [float(x) for x in out[4]]
    widths = fast._cascade_widths(res * res, factor=2,
                                  min_width=fast._MIN_WIDTH)
    print(f"stats casc2: rays={nr:.0f} rows={n_rows:.0f} "
          f"busy={n_busy / max(n_rows, 1):.3f} "
          f"width_equiv={n_rows / (res * res):.1f}", flush=True)
    for w, r in zip(widths, stage_rows):
        print(f"  stage w={int(w):8d}: iters={r / w:7.0f}", flush=True)


def main(argv=None) -> dict:
    args = parse_args(argv)
    dev = device_of(args.platform)
    scene = sc.scene("smoke", dev)
    res = args.res
    camera = sc.camera(res, dev)
    if not args.no_stats:
        stats_render(scene, camera, res, args.spp)
    configs = CONFIGS
    if args.only:
        configs = [(n, kw) for n, kw in configs
                   if any(s in n for s in args.only)]
    results = {}
    for name, kw in configs:
        results[name] = config_row(scene, camera, res, args.spp, args.reps,
                                   name, kw)
        print(f"{name}: BEST {results[name]['mrays_s']:.2f} Mrays/s",
              flush=True)
    out = {"res": res, "spp": args.spp, "reference_best": REFERENCE_BEST,
           "results": results}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
        print("wrote", args.out)
    return out


if __name__ == "__main__":
    main()
    sys.exit(0)
