"""BASELINE config 5: recover a 256^3 density grid from target renders.

Port of benchmarks/inverse_256.py, with its flags, defaults and recipe:

  * the phantom: medical_volume(n^3, n_blobs=40), albedo 0.6, scale 12
    (center-line optical depth ~7, an observable interior);
  * Russian roulette off (the replay detaches RR decisions, so RR-on
    gradients are biased), max_path_length 64;
  * 8 orbit views at radius 100, fov 0.8, 128^2, rendered as targets at
    64 spp through two-level fastSK (models/fast);
  * a coarse-to-fine pyramid n/4 -> n/2 -> n at 80/60/40 steps, trilinear
    upsampling between levels, TV prior 2e-3;
  * Adam at lr 0.05, spp 8 split into 2 chunks, 2 views per step, the
    two-level replay (models/differentiable).

    python -m cudavolumerenderer_tpu_torch.benchmarks.inverse_256 \\
        [--platform cuda|cpu] [--n 256] [--res 128] [--views 8] [--spp 8] \\
        [--target-spp 64] [--steps 80 60 40] [--out path] [--resume]

`--platform cuda` (the default) runs on the card and raises without one;
`--platform cpu` runs on the CPU, for checking at a small size (--n 16
--res 8).  The JSON line has the JAX script's keys and, from this run,
the losses of each level, the seconds of each step and of each forward+backward program (ended by
a device synchronise) per level, the fused replay's loop iterations in
the primal and in pass B per program, and the card's peak allocated
memory (torch.cuda.max_memory_allocated; null on the CPU).  The JAX
script writes its JSON to benchmarks/results_inverse256.json; this one
writes a file only when --out names it, and keeps its checkpoints under
the temporary directory unless --ckpt-dir names another.

Done-criterion (VERDICT r1): grid_mse_ratio <= 0.5 at 256^3.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
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
        prog="python -m cudavolumerenderer_tpu_torch.benchmarks.inverse_256")
    ap.add_argument("--platform", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--n", type=int, default=256)
    ap.add_argument("--res", type=int, default=128)
    ap.add_argument("--views", type=int, default=8)
    ap.add_argument("--spp", type=int, default=8)
    ap.add_argument("--target-spp", type=int, default=64)
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument(
        "--scale", type=float, default=12.0,
        help="sigma_t multiplier; the phantom's center-line optical depth "
        "is ~7 (an observable interior)")
    ap.add_argument("--tv", type=float, default=2e-3)
    ap.add_argument(
        "--spp-chunks", type=int, default=2,
        help="split each view's grad into this many forward+backward "
        "programs of spp/spp_chunks samples")
    ap.add_argument("--steps", type=int, nargs="+", default=[80, 60, 40],
                    help="steps per pyramid level")
    ap.add_argument("--out", default=None, help="also write the JSON here")
    ap.add_argument(
        "--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "inv256_ckpt"),
        help="checkpoint directory (per-level subdirs)")
    ap.add_argument(
        "--resume", action="store_true",
        help="resume from the deepest checkpoint in --ckpt-dir (Adam "
        "moments and the seed schedule are restored); targets are re-used "
        "from the cache written on the first run")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Run the recovery; print and return the result dict."""
    args = parse_args(argv)
    dev = device_of(args.platform)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

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

    os.makedirs(args.ckpt_dir, exist_ok=True)
    tgt_cache = os.path.join(
        args.ckpt_dir,
        f"targets_n{n}_v{args.views}_r{args.res}_s{args.target_spp}"
        f"_sc{args.scale:g}.npz",
    )
    t0 = time.time()
    if args.resume and os.path.exists(tgt_cache):
        targets = torch.from_numpy(np.load(tgt_cache)["targets"]).to(dev)
        t_targets = 0.0
        print(f"targets: loaded cache {tgt_cache}", flush=True)
    else:
        targets = inverse.render_view_targets(
            gt, albedo, spec, views, settings, res, args.target_spp, True,
            device=dev,
        )
        host_targets = targets.cpu().numpy()
        t_targets = time.time() - t0
        np.savez(tgt_cache, targets=host_targets)
        print(f"targets: {args.views} views x {args.target_spp} spp, "
              f"{t_targets:.1f}s", flush=True)

    sizes = [n // 4, n // 2, n]
    levels = list(zip(sizes, args.steps))

    config = inverse.InverseConfig(
        resolution=res, spp=args.spp, learning_rate=args.lr, seed=17,
        two_level=True, tv_weight=args.tv, views_per_step=2,
        spp_chunks=args.spp_chunks,
        checkpoint_dir=args.ckpt_dir, checkpoint_every=10,
    )

    def progress(lvl, step, loss):
        if step % 10 == 0:
            print(f"  {lvl} step {step:4d} loss {loss:.6f}", flush=True)

    stats = {}
    t0 = time.time()
    density, losses = inverse.run_inverse_pyramid(
        targets, views, albedo, spec, settings, config, levels,
        init_value=0.25, progress=progress, resume=args.resume, device=dev,
        stats=stats,
    )
    density = density.cpu().numpy()
    wall = time.time() - t0

    mse0 = float(((0.25 - gt) ** 2).mean())
    mse1 = float(((density - gt) ** 2).mean())
    per_level = stats.get("levels", {})

    def by_level(key):
        return {lvl: s.get(key, []) for lvl, s in per_level.items()}

    result = {
        "grid": f"{n}^3",
        "scale": args.scale,
        "views": args.views,
        "res": args.res,
        "spp": args.spp,
        "levels": [list(l) for l in levels],
        "tv_weight": args.tv,
        "wall_s": round(wall, 1),
        "target_render_s": round(t_targets, 1),
        "loss_first": round(next(l[0] for l in losses if l), 6),
        "loss_last": round(next(l[-1] for l in reversed(losses) if l), 6),
        "grid_mse_init": round(mse0, 6),
        "grid_mse_final": round(mse1, 6),
        "grid_mse_ratio": round(mse1 / mse0, 4),
        "platform": dev.type,
        "losses": losses,
        "step_s": by_level("step_s"),
        "program_s": by_level("program_s"),
        "primal_iters": by_level("primal_iters"),
        "pass_b_iters": by_level("pass_b_iters"),
        "max_memory_allocated": (torch.cuda.max_memory_allocated(dev)
                                 if dev.type == "cuda" else None),
    }
    print(json.dumps(result), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=2)
    return result


if __name__ == "__main__":
    main()
    sys.exit(0)
