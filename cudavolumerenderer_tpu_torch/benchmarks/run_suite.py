"""Benchmark suite reproducing the reference's measurement protocol
(thesis tables 4.1-4.6, 6.2-6.3; BASELINE.md): kernels x scenes in
Mrays/s, plus the tiling table.

Port of benchmarks/run_suite.py, with its flags, rows, JSON keys and
timing protocol: per row one render through create_renderer(...).render()
to warm up, then one timed render (wall on the host clock, the image copied
to the host); per scene also fastSK two-level through fast.render_tile
directly (seed 1234 to warm up, seed 1300 timed, fenced by the n_rays
read).  Scenes (scene_classes.py): bucky 32^3 at 256^2 x 20, smoke
128x128x50 at scale 800 and 400^2 x 4, medical 256^3 at scale 100 and
512^2 x 4 (left out under --quick); the schedulers take n_lanes = 2^17.

--tiling runs thesis Table 4.2 instead: bucky at 1920^2 x 5 iterations
through fastSK two-level on 1, 2, 4, 8, 32 and 64 tiles a side.  The
renderer renders all tiles of a pass in one cascade when each tile holds
at most MULTI_TILE_LANES lanes and all of them at most MAX_BATCH_LANES
(models/renderer.py); the other rows render their tiles one after
another, a cascade each.

    python -m cudavolumerenderer_tpu_torch.benchmarks.run_suite \\
        [--platform cuda|cpu] [--quick] [--tiling] [--out path] \\
        [--kernels naiveSK regenerationSK streamingSK fastSK]

Each row also carries n_rays and the kernels' counts over its two renders
(scene_classes.RowCounts: launches, host reads, eager evaluations); a
tiling row the path its passes took.  The JSON is written only to --out
(the JAX script writes benchmarks/results.json by default).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from ..cli import device_of
from ..config import Config, Kernel
from ..models import fast
from ..models.renderer import create_renderer
from ..scene.types import RenderSettings
from . import scene_classes as sc

#: (row name, scene class) of the kernels x scenes table
SCENES = (("bucky32", "bucky"), ("smoke128", "smoke"), ("medical256", "medical"))
#: the tiling table: image side, iterations, tiles a side
TILING = (1920, 5, (1, 2, 4, 8, 32, 64))
N_LANES = 1 << 17
#: the keys main's result holds, by mode (its flags): the JAX script's JSON
#: keys
KEYS = {"": {"time_s", "mrays_per_sec"},
        "--tiling": {"time_s", "paths_per_tile"}}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m cudavolumerenderer_tpu_torch.benchmarks.run_suite")
    ap.add_argument("--platform", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--quick", action="store_true")
    ap.add_argument(
        "--tiling", action="store_true",
        help="reproduce the thesis Table 4.2 tiling protocol "
        "(1920x1920, 5 iterations, tile grids 1..64 per side)")
    ap.add_argument("--out", default=None, help="write the JSON here")
    ap.add_argument(
        "--kernels", nargs="+",
        default=["naiveSK", "regenerationSK", "streamingSK", "fastSK"])
    return ap.parse_args(argv)


def renderer_row(renderer) -> dict:
    """One warm-up render and one timed render of `renderer` (wall with the
    image copy), counted."""
    kernels = sc.SCHEDULER_KERNELS[renderer.config.kernel.value]
    with sc.RowCounts(*kernels) as rc:
        renderer.render()  # warm-up
        t0 = time.time()
        renderer.render()
        dt = time.time() - t0
    return {"time_s": dt, "n_rays": renderer.n_rays, **rc.counts}


def tiling_row(scene, camera, res: int, iters: int, nt: int) -> dict:
    """Table 4.2's row of nt x nt tiles: fastSK two-level on the
    res^2 x iters image."""
    config = Config(
        kernel=Kernel.FAST_SK, iterations=iters, resolution=(res, res),
        n_tiles=(nt, nt), two_level=True,
        settings=RenderSettings.from_flags(True),
    )
    renderer = create_renderer(scene, camera, config)
    row = renderer_row(renderer)
    row["paths_per_tile"] = (res // nt + (res % nt > 0)) ** 2 * iters
    row["tiles_path"] = ("batched" if renderer._use_multi()
                         else f"sequential, {nt * nt} cascade(s)")
    return row


def kernel_row(scene, camera, kname: str, res: int, iters: int) -> dict:
    """The kernels x scenes row of `kname`: create_renderer at n_lanes
    2^17."""
    config = Config(
        kernel=Kernel.from_name(kname), iterations=iters,
        resolution=(res, res), n_lanes=N_LANES,
        settings=RenderSettings.from_flags(True),
    )
    row = renderer_row(create_renderer(scene, camera, config))
    row["mrays_per_sec"] = row["n_rays"] / (row["time_s"] * 1e6)
    return row


def fast_2l_row(scene, camera, res: int, iters: int) -> dict:
    """fastSK two-level through render_tile directly: seed 1234 warms up,
    seed 1300 is timed, fenced by the n_rays read."""
    dev = scene.device
    settings = RenderSettings.from_flags(True)
    off = torch.zeros(2, dtype=torch.float32, device=dev)
    with sc.RowCounts("fastbody") as rc:
        img, _ = fast.render_tile(scene, camera, settings, (res, res), off,
                                  (res, res), iters, 1234, 0, two_level=True)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)  # the JAX script's block_until_ready
        t0 = time.time()
        img, nr = fast.render_tile(scene, camera, settings, (res, res), off,
                                   (res, res), iters, 1300, 0, two_level=True)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dt = time.time() - t0
    nr = float(nr)
    return {"time_s": dt, "mrays_per_sec": nr / (dt * 1e6), "n_rays": nr,
            **rc.counts}


def write(results: dict, out) -> None:
    if out:
        with open(out, "w") as f:
            json.dump(results, f, indent=2)


def main(argv=None) -> dict:
    args = parse_args(argv)
    dev = device_of(args.platform)
    results = {}
    if args.tiling:
        res, iters, grids = TILING
        scene = sc.scene("bucky", dev)
        camera = sc.camera(res, dev)
        for nt in grids:
            key = f"tiling1920/fastSK-2L/{nt}x{nt}"
            results[key] = tiling_row(scene, camera, res, iters, nt)
            print(f"{key}: {results[key]['time_s']:.2f}s "
                  f"({results[key]['tiles_path']}, "
                  f"{results[key]['fastbody']} body launches, "
                  f"{results[key]['reads']} host reads)", flush=True)
            write(results, args.out)  # incremental, as the JAX script
        if args.out:
            print(f"wrote {args.out}")
        return results

    scenes = [s for s in SCENES if not (args.quick and s[1] == "medical")]
    for scene_name, cls in scenes:
        scene = sc.scene(cls, dev)
        res, iters = sc.size(cls)
        camera = sc.camera(res, dev)
        for kname in args.kernels:
            key = f"{scene_name}/{kname}"
            results[key] = kernel_row(scene, camera, kname, res, iters)
            print(f"{key}: {results[key]['time_s']:.2f}s, "
                  f"{results[key]['mrays_per_sec']:.2f} Mrays/s", flush=True)
        key = f"{scene_name}/fastSK-2L"
        results[key] = fast_2l_row(scene, camera, res, iters)
        print(f"{key}: {results[key]['time_s']:.2f}s, "
              f"{results[key]['mrays_per_sec']:.2f} Mrays/s", flush=True)
    write(results, args.out)
    if args.out:
        print(f"wrote {args.out}")
    return results


if __name__ == "__main__":
    main()
    sys.exit(0)
