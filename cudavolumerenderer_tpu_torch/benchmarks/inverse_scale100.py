"""Recoverability at the medical-class extinction scale = 100: the
observability split of a recovered grid.

Port of benchmarks/inverse_scale100.py, with its flags, defaults and JSON
keys.  At scale 100 the phantom's centre-line optical depth is ~57, so
interior voxels are dark in every view and carry exponentially suppressed
gradients.  The driver runs inverse_256.py's converging recipe at scale 100
on a 64^3 grid:

  * the phantom medical_volume(n^3, n_blobs=40), albedo 0.6, Russian
    roulette off, max_path_length 64;
  * 6 orbit views at radius 100, fov 0.8, 64^2, rendered as targets at 64
    spp through two-level fastSK;
  * a coarse-to-fine pyramid n/4 -> n/2 -> n at 30/20/15 steps, TV prior
    2e-3, Adam at lr 0.05, spp 8, 2 views per step, the two-level replay;

then splits the grid-MSE (final / initial) by the identifiability
criterion tau_min(v) (models/inverse.observability_depth: the least of the
six axis paths' optical depths to the boundary, an upper bound on the true
escape depth) into the observable shell (tau_min < tau_c) and the interior.

    python -m cudavolumerenderer_tpu_torch.benchmarks.inverse_scale100 \\
        [--platform cuda|cpu] [--n 64] [--res 64] [--views 6] [--spp 8] \\
        [--target-spp 64] [--scale 100] [--tau-c 5] [--tv 2e-3] \\
        [--steps 30 20 15] [--out path]

`--platform cuda` (the default) runs on the card and raises without one;
`--platform cpu` runs on the CPU, for checking at a small size.  The JSON
has the JAX script's keys, and `platform` and the card's name; the JAX
script writes it to benchmarks/results_scale100.json, this one only to
--out.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from ..cli import device_of
from ..models import inverse
from ..models.differentiable import SceneSpec
from ..scene import procedural
from ..scene.types import RenderSettings


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m cudavolumerenderer_tpu_torch.benchmarks."
        "inverse_scale100")
    ap.add_argument("--platform", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--n", type=int, default=64)
    ap.add_argument("--res", type=int, default=64)
    ap.add_argument("--views", type=int, default=6)
    ap.add_argument("--spp", type=int, default=8)
    ap.add_argument("--target-spp", type=int, default=64)
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--scale", type=float, default=100.0)
    ap.add_argument("--tau-c", type=float, default=5.0)
    ap.add_argument("--tv", type=float, default=2e-3)
    ap.add_argument("--steps", type=int, nargs="+", default=[30, 20, 15])
    ap.add_argument("--out", default=None, help="also write the JSON here")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Run the recovery and the split; print and return the result dict."""
    args = parse_args(argv)
    dev = device_of(args.platform)
    n = args.n
    gt = procedural.medical_volume((n, n, n), n_blobs=40)
    albedo = np.full((1, 1, 1, 4), 0.6, np.float32)
    spec = SceneSpec(scale=args.scale, max_density=1.0)
    settings = RenderSettings.from_flags(
        True, russian_roulette=False, max_path_length=64
    )
    res = (args.res, args.res)
    views = inverse.orbit_camera_specs(
        args.views, radius=100.0, res=res, fov_x_deg=0.8
    )

    t0 = time.time()
    targets = inverse.render_view_targets(
        gt, albedo, spec, views, settings, res, args.target_spp, True,
        device=dev,
    )
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t_targets = time.time() - t0
    print(f"targets: {args.views} views x {args.target_spp} spp, "
          f"{t_targets:.1f}s", flush=True)

    levels = [(n // 4, args.steps[0]), (n // 2, args.steps[1]),
              (n, args.steps[2])]
    config = inverse.InverseConfig(
        resolution=res, spp=args.spp, learning_rate=args.lr, seed=17,
        two_level=True, tv_weight=args.tv, views_per_step=2,
    )

    def progress(lvl, step, loss):
        if step % 10 == 0:
            print(f"  {lvl} step {step:4d} loss {loss:.6f}", flush=True)

    t0 = time.time()
    density, losses = inverse.run_inverse_pyramid(
        targets, views, albedo, spec, settings, config, levels,
        init_value=0.25, progress=progress, device=dev,
    )
    rec = density.cpu().numpy()
    wall = time.time() - t0

    mse0 = float(((0.25 - gt) ** 2).mean())
    mse1 = float(((rec - gt) ** 2).mean())
    split = inverse.split_mse_by_observability(
        rec, gt, 0.25, args.scale, tau_c=args.tau_c
    )
    tau = inverse.observability_depth(gt, args.scale)
    result = {
        "grid": f"{n}^3",
        "scale": args.scale,
        "views": args.views,
        "res": args.res,
        "spp": args.spp,
        "levels": [list(l) for l in levels],
        "wall_s": round(wall, 1),
        "loss_first": round(next(l[0] for l in losses if l), 6),
        "loss_last": round(next(l[-1] for l in reversed(losses) if l), 6),
        "grid_mse_ratio_overall": round(mse1 / mse0, 4),
        "center_tau_min": round(float(tau[n // 2, n // 2, n // 2]), 2),
        "observability_split": split,
        "target_render_s": round(t_targets, 1),
        "platform": dev.type,
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
    }
    print(json.dumps(result, indent=2), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=2)
    return result


if __name__ == "__main__":
    main()
    sys.exit(0)
