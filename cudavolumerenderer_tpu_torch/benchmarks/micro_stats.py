"""Wavefront anatomy: evaluations, busy-lane fraction and row rate of
fastSK (one- and two-level) on each scene class.

Port of benchmarks/micro_stats.py: per class (scene_classes.py, at its
published size) and level, fast.render_tile with with_stats=True once at
seed 1 to warm up (fenced by the image sum) and once timed at seed 99
(perf_counter, fenced by the image sum).  A render is read as n_iters
full-width rounds: rows (the lane-rows summed over evaluations) over the
pixel count.

    python -m cudavolumerenderer_tpu_torch.benchmarks.micro_stats \\
        [--platform cuda|cpu]

Returns (and prints as JSON) {"<class> 2L=<0|1>": {"time", "rays",
"iters", "busy", "mrays_s", "rows_s", "rows_per_ray",
"busyrows_per_ray", counts}}: the fields the JAX script prints.
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
#: the keys main's result holds, by mode (its flags): what the JAX script
#: prints, under the port's names (the script writes no JSON)
KEYS = {"": {"time", "rays", "iters", "busy", "mrays_s", "rows_s",
             "rows_per_ray", "busyrows_per_ray"}}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m cudavolumerenderer_tpu_torch.benchmarks.micro_stats")
    ap.add_argument("--platform", choices=("cuda", "cpu"), default="cuda")
    return ap.parse_args(argv)


def stats_row(scene, camera, res: int, iters: int, two_level: bool) -> dict:
    settings = RenderSettings.from_flags(True)
    args = dict(scene=scene, camera=camera, settings=settings,
                tile_dim=(res, res),
                tile_offset=torch.zeros(2, dtype=torch.float32,
                                        device=scene.device),
                full_resolution=(res, res), spp=iters, two_level=two_level,
                with_stats=True)
    with sc.RowCounts("fastbody") as rc:
        out = fast.render_tile(seed=1, path_id_base=0, **args)
        _ = float(out[0].sum())  # sync via readback
        t0 = time.perf_counter()
        out = fast.render_tile(seed=99, path_id_base=0, **args)
        float(out[0].sum())
        dt = time.perf_counter() - t0
    n_rays, rows, n_busy = float(out[1]), float(out[2]), float(out[3])
    n_lanes = res * res
    return {
        "time": dt, "rays": n_rays, "iters": rows / n_lanes,
        "busy": n_busy / rows, "mrays_s": n_rays / dt / 1e6,
        "rows_s": rows / dt / 1e6, "rows_per_ray": rows / n_rays,
        "busyrows_per_ray": n_busy / n_rays, "rows": rows, **rc.counts,
    }


def main(argv=None) -> dict:
    args = parse_args(argv)
    dev = device_of(args.platform)
    results = {}
    for name in NAMES:
        scene = sc.scene(name, dev)
        res, iters = sc.size(name)
        camera = sc.camera(res, dev)
        for two_level in (False, True):
            r = stats_row(scene, camera, res, iters, two_level)
            results[f"{name} 2L={int(two_level)}"] = r
            print(
                f"{name:8s} 2L={int(two_level)} time={r['time']:7.3f}s "
                f"rays={r['rays'] / 1e6:7.2f}M iters~={r['iters']:7.0f} "
                f"busy={r['busy'] * 100:5.1f}% "
                f"Mrays/s={r['mrays_s']:7.2f} "
                f"rows/s(all)={r['rows_s']:7.1f}M "
                f"rows/ray={r['rows_per_ray']:6.1f} "
                f"busyrows/ray={r['busyrows_per_ray']:5.1f}",
                flush=True,
            )
    print(json.dumps(results, indent=1), flush=True)
    return results


if __name__ == "__main__":
    main()
    sys.exit(0)
