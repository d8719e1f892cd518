"""Scaling-efficiency harness: rays/s over group sizes 1..N (port of
benchmarks/scaling_efficiency.py).

Weak scaling: spp per rank held constant (total spp = n *
spp_per_device), the kernel fastSK two-level through
parallel.shard.render_sharded.  One row per group size n in
(1, 2, 4, 8, 16, 32) up to the size of the group the script is launched
in, and that size: the first n ranks render in a subgroup while the
others wait.  Each rep ends in a host read of the image sum and n_rays
(the fence); rep 0 is discarded and the best of the others kept.
efficiency(n) = rays_per_s(n) / (n * rays_per_s(1)).

--compare-plain also times fast.render_tile alone at the N = 1 workload
on rank 0's device: the overhead of the sharded dispatch (the group and
the all_reduce) at one rank.

Launch one copy per rank as scripts/run_multihost is launched
(--coordinator / --num-processes / --process-id, or torchrun); alone it
is a group of one:

  python -m cudavolumerenderer_tpu_torch.benchmarks.scaling_efficiency \\
      [--platform cuda|cpu] [--res 128] [--spp-per-device 4] [--reps 3] \\
      [--compare-plain] [--json-out path]

Ranks render on the card (NCCL) and the script raises without one;
--platform cpu runs a gloo group on the CPU, where ranks share the
host's cores, so its efficiency bounds collective and host overhead, not
interconnect scaling.  The JAX script's --host-devices has no
counterpart (one rank is one device).
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch
import torch.distributed as dist

from ..models import fast
from ..ops.camera import make_camera
from ..parallel.mesh import Mesh
from ..parallel.shard import render_sharded
from ..scene import procedural
from ..scene.types import RenderSettings, make_medium, make_scene
from ..scripts.run_multihost import add_group_args, join_group

SIZES = (1, 2, 4, 8, 16, 32)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m cudavolumerenderer_tpu_torch.benchmarks."
        "scaling_efficiency")
    add_group_args(ap)
    ap.add_argument("--res", type=int, default=128)
    ap.add_argument("--spp-per-device", type=int, default=4)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--json-out", default=None)
    ap.add_argument(
        "--compare-plain", action="store_true",
        help="also time the unsharded fast.render_tile at the N=1 "
        "workload on rank 0's device: the sharded dispatch's overhead at "
        "one rank")
    return ap.parse_args(argv)


def bench_scene(dev: torch.device):
    """The JAX script's scene: a 32^3 blob (5 blobs), albedo (d, 0.5,
    1 - d), scale 40."""
    dens = procedural.blob_volume((32, 32, 32), n_blobs=5)
    albedo = np.stack([dens, 0.5 * np.ones_like(dens), 1.0 - dens], axis=-1)
    return make_scene(make_medium(dens, albedo, scale=40.0, max_density=1.0,
                                  device=dev))


def timed_reps(run, reps: int, tag: str, verbose: bool = True):
    """(best seconds of reps 1..reps, n_rays) of run(seed) -> n_rays;
    rep 0 is the warm-up."""
    times, rays = [], 0.0
    for rep in range(reps + 1):
        t0 = time.perf_counter()
        rays = run(1000 + rep)
        dt = time.perf_counter() - t0
        if rep:
            times.append(dt)
        if verbose:
            print(f"  {tag} rep{rep}: {dt * 1e3:.1f} ms ({rays:.0f} rays)",
                  flush=True)
    return min(times), rays


def main(argv=None) -> dict:
    """Runs the benchmark; returns the JSON object on rank 0 ({} on the
    others)."""
    args = parse_args(argv)
    dev = join_group(args)
    try:
        return run(args, dev)
    finally:
        dist.destroy_process_group()


def run(args, dev: torch.device) -> dict:
    res = args.res
    scene = bench_scene(dev)
    camera = make_camera(res, res, device=dev)
    settings = RenderSettings.from_flags(True, russian_roulette=False)
    world, rank = dist.get_world_size(), dist.get_rank()
    rows = []
    for n in sorted({n for n in SIZES if n <= world} | {world}):
        group = dist.new_group(list(range(n)))
        spp = args.spp_per_device * n
        if rank < n:
            mesh = Mesh(group=group, world_size=n, rank=rank,
                        axis_name="rays", device=dev)

            def run_once(seed):
                img, n_rays = render_sharded(
                    scene, camera, settings, (res, res), spp, seed, mesh,
                    kernel="fast", two_level=True)
                float(img.sum())
                return float(n_rays)

            best, rays = timed_reps(run_once, args.reps, f"N={n}", rank == 0)
            rows.append({"n": n, "spp": spp, "s": best,
                         "rays_per_s": rays / best})
        dist.barrier()
    if rank != 0:
        return {}
    for r in rows:
        r["efficiency"] = r["rays_per_s"] / (r["n"] * rows[0]["rays_per_s"])
        print(f"N={r['n']:2d}: {r['rays_per_s'] / 1e6:7.3f} Mrays/s  "
              f"efficiency {r['efficiency'] * 100:5.1f}%")

    plain_row = None
    if args.compare_plain:
        def plain_once(seed):
            img, n_rays = fast.render_tile(
                scene, camera, settings, (res, res),
                torch.zeros(2, dtype=torch.float32, device=dev), (res, res),
                args.spp_per_device, seed, 0, two_level=True)
            float(img.sum())
            return float(n_rays)

        plain_s, _ = timed_reps(plain_once, args.reps, "plain")
        sharded_s = rows[0]["s"]
        overhead = sharded_s / plain_s - 1.0
        plain_row = {"plain_s": plain_s, "sharded_n1_s": sharded_s,
                     "sharded_dispatch_overhead": overhead}
        print(f"plain dispatch: {plain_s * 1e3:.1f} ms vs sharded N=1 "
              f"{sharded_s * 1e3:.1f} ms -> overhead {overhead * 100:+.1f}%")

    out = {"platform": dev.type, "n_devices": world, "res": res,
           "spp_per_device": args.spp_per_device, "rows": rows,
           "plain_comparison": plain_row,
           "device_name": (torch.cuda.get_device_name(dev)
                           if dev.type == "cuda" else None),
           "pod_invocation": (
               "per host: torchrun --nnodes H --nproc-per-node G "
               "--rdzv-endpoint HOST0:PORT -m "
               "cudavolumerenderer_tpu_torch.benchmarks.scaling_efficiency "
               "--json-out results_scaling.json (rows cover the global "
               "group)"),
           "note": ("CPU ranks share the host's cores: efficiency below "
                    "~100% bounds collective and host overhead, not "
                    "interconnect scaling" if dev.type == "cpu" else
                    "real-device measurement")}
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(out, f, indent=1)
        print("wrote", args.json_out)
    return out


if __name__ == "__main__":
    main()
