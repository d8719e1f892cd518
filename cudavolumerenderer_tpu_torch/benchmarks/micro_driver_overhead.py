"""Where renderer.render()'s time goes against a direct render_tile.

Port of benchmarks/micro_driver_overhead.py: the bucky class (32^3,
256^2 x 20, fastSK two-level, n_lanes 2^17) through four paths, each
timed on the host clock:

  * direct: fast.render_tile, fenced by the n_rays read (3 reps after a
    warm-up at seed 0);
  * direct+img: the same, fenced by copying the image to the host and
    reading n_rays (2 reps);
  * driver: create_renderer(...).render() (its image copied to the host;
    3 reps after a warm-up, the seed advanced each rep);
  * driver-noimg: the driver loop (init_rendering, run_iterations until
    image_complete) fenced by the n_rays read, without get_image (2 reps).

    python -m cudavolumerenderer_tpu_torch.benchmarks.micro_driver_overhead \\
        [--platform cuda|cpu]

Returns (and prints as JSON) {"compiled_n_rays", path: {"times_s",
"mrays_s", "n_rays", counts}}; the JAX script only prints.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from ..cli import device_of
from ..config import Config, Kernel
from ..models import fast
from ..models.renderer import create_renderer
from ..scene.types import RenderSettings
from . import scene_classes as sc

N_LANES = 1 << 17
#: the keys main's result holds, by mode (its flags): what the JAX script
#: prints, under the port's names (the script writes no JSON)
KEYS = {"": {"compiled_n_rays", "direct", "direct+img", "driver",
             "driver-noimg"}}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m cudavolumerenderer_tpu_torch.benchmarks."
        "micro_driver_overhead")
    ap.add_argument("--platform", choices=("cuda", "cpu"), default="cuda")
    return ap.parse_args(argv)


def timed(label: str, reps: int, run) -> dict:
    """`reps` calls of run(rep) -> n_rays, each timed; counted.  A run that
    returns a function has its n_rays read after the clock stops."""
    times, rates = [], []
    with sc.RowCounts("fastbody") as rc:
        for rep in range(reps):
            t0 = time.time()
            nr = run(rep)
            dt = time.time() - t0
            nr = nr() if callable(nr) else nr
            times.append(dt)
            rates.append(nr / dt / 1e6)
            print(f"{label} rep{rep}: {dt:.3f}s  {nr / dt / 1e6:.2f} Mrays/s",
                  flush=True)
    return {"times_s": times, "mrays_s": rates, "n_rays": nr, **rc.counts}


def main(argv=None) -> dict:
    args = parse_args(argv)
    dev = device_of(args.platform)
    print("devices:", torch.cuda.get_device_name(dev) if dev.type == "cuda"
          else "cpu", flush=True)
    scene = sc.scene("bucky", dev)
    res, iters = sc.size("bucky")
    camera = sc.camera(res, dev)
    settings = RenderSettings.from_flags(True)
    config = Config(
        kernel=Kernel.FAST_SK, iterations=iters, resolution=(res, res),
        n_tiles=(1, 1), n_lanes=N_LANES, two_level=True, settings=settings,
    )
    off = torch.tensor([0.0, 0.0], dtype=torch.float32, device=dev)

    def direct(seed):
        return fast.render_tile(scene, camera, settings, (res, res), off,
                                (res, res), iters, seed, 0,
                                lanes_per_pixel=1, two_level=True)

    results = {}
    img, n_rays = direct(0)
    results["compiled_n_rays"] = float(n_rays)  # warm-up + readback fence
    print("compiled; n_rays:", results["compiled_n_rays"], flush=True)
    results["direct"] = timed("direct", 3, lambda rep: float(direct(rep + 1)[1]))

    def direct_img(rep):
        img, n_rays = direct(10 + rep)
        np.asarray(img.cpu())
        return float(n_rays)

    results["direct+img"] = timed("direct+img", 2, direct_img)

    renderer = create_renderer(scene, camera, config)
    renderer.render()  # warm-up

    def driver(rep):
        config.seed += 1
        renderer.render()
        return lambda: renderer.n_rays  # read after the clock, as in JAX

    results["driver"] = timed("driver", 3, driver)

    def driver_noimg(rep):
        config.seed += 1
        renderer.init_rendering()
        while not renderer.image_complete():
            renderer.run_iterations(spp=renderer._spp_per_launch())
        return renderer.n_rays  # scalar fence only

    results["driver-noimg"] = timed("driver-noimg", 2, driver_noimg)
    print(json.dumps(results, indent=1), flush=True)
    return results


if __name__ == "__main__":
    main()
    sys.exit(0)
