"""Multi-process sharded rendering / inverse-rendering entry point (port
of scripts/run_multihost.py).

Launch one copy per rank, one rank per card:

    # host 0
    python -m cudavolumerenderer_tpu_torch.scripts.run_multihost \\
        --coordinator 10.0.0.1:1234 --num-processes 2 --process-id 0 scene.xml
    # host 1
    python -m cudavolumerenderer_tpu_torch.scripts.run_multihost \\
        --coordinator 10.0.0.1:1234 --num-processes 2 --process-id 1 scene.xml

or under torchrun (its RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR and
MASTER_PORT are read when --coordinator is not given).  Without either
the script runs as a group of one.  Renders with samples sharded over all
ranks (all_reduce of the image), writes the image from rank 0.  With
--inverse TARGET.hdr it instead runs the sharded inverse-rendering
optimization (gradient all_reduce each step) and writes the recovered
density to OUTPUT_recovered.npz.

Ranks render on the card over NCCL, and the script raises without one;
`--platform cpu` runs a gloo group on the CPU.  The JAX script's
--host-devices (virtual CPU devices per process) has no counterpart,
since one rank is one device: start more processes instead.
"""

from __future__ import annotations

import argparse
import math
import os
import socket
import sys

import numpy as np
import torch

from ..config import Config
from ..models.differentiable import CameraSpec, SceneSpec
from ..parallel.mesh import initialize_distributed, make_mesh
from ..parallel.shard import make_inverse_step, render_sharded
from ..scene.loader import load_scene
from ..scene.types import RenderSettings
from ..utils.image import load_hdr, save_hdr


def add_group_args(parser: argparse.ArgumentParser) -> None:
    """The flags join_group reads: the group and the platform."""
    parser.add_argument("--coordinator", default=None,
                        help="host:port of rank 0 (omit for torchrun's "
                        "environment or a single process)")
    parser.add_argument("--num-processes", type=int, default=1)
    parser.add_argument("--process-id", type=int, default=0)
    parser.add_argument("--platform", choices=("cuda", "cpu"),
                        default="cuda",
                        help="cuda (NCCL, the default) or cpu (gloo)")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="python -m cudavolumerenderer_tpu_torch.scripts.run_multihost")
    parser.add_argument("scene_file")
    add_group_args(parser)
    parser.add_argument("-r", "--resolution", type=int, nargs="+",
                        default=[512, 512])
    parser.add_argument("-i", "--iterations", type=int, default=32)
    parser.add_argument("--seed", type=int, default=1234)
    parser.add_argument("-o", "--output", default="multihost_render")
    parser.add_argument("--inverse", default=None,
                        help="target .hdr: run inverse recovery instead")
    parser.add_argument("--steps", type=int, default=100)
    return parser


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def join_group(args) -> torch.device:
    """Initialize the process group from --coordinator, torchrun's
    environment, or as a group of one; returns this rank's device."""
    if args.coordinator is not None:
        return initialize_distributed(
            init_method=f"tcp://{args.coordinator}",
            world_size=args.num_processes, rank=args.process_id,
            device=args.platform)
    if "WORLD_SIZE" in os.environ:
        return initialize_distributed(device=args.platform)
    return initialize_distributed(
        init_method=f"tcp://127.0.0.1:{_free_port()}", world_size=1, rank=0,
        device=args.platform)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    dev = join_group(args)
    try:
        return run(args, dev)
    finally:
        torch.distributed.destroy_process_group()


def run(args, dev: torch.device) -> int:
    res = args.resolution
    if len(res) == 1:
        res = [res[0], res[0]]
    res = (res[0], res[1])
    config = Config(scene_file=args.scene_file, resolution=res,
                    iterations=args.iterations, seed=args.seed)
    scene, camera = load_scene(config, device=dev)
    mesh = make_mesh(device=dev)
    n_dev = mesh.world_size
    spp = max(args.iterations // n_dev, 1) * n_dev

    if args.inverse is None:
        img, n_rays = render_sharded(
            scene, camera, config.settings, res, spp, args.seed, mesh)
        if mesh.rank == 0:
            save_hdr(args.output + ".hdr", img.cpu().numpy() / spp)
            print(f"rendered {spp} spp on {n_dev} devices, "
                  f"{float(n_rays):.0f} rays -> {args.output}.hdr")
        return 0

    target = torch.from_numpy(load_hdr(args.inverse)).to(dev)
    settings = RenderSettings.from_flags(
        True, russian_roulette=False, max_path_length=32, bsdf_kind="null")
    spec = SceneSpec.from_scene(scene)
    fov = math.degrees(2 * math.atan(float(camera.raster_to_view[0])))
    cam_spec = CameraSpec(res_x=res[0], res_y=res[1], fov_x_deg=fov)
    step = make_inverse_step(
        spec, cam_spec, settings, res, spp_per_device=max(spp // n_dev, 1),
        mesh=mesh, optimizer=lambda p: torch.optim.Adam(p, lr=0.05))
    params = ((scene.medium.density.data * 0.5).requires_grad_(),
              scene.medium.albedo.data.clone().requires_grad_())
    for it in range(args.steps):
        params, loss = step(params, target, args.seed + it)
        if mesh.rank == 0 and it % 10 == 0:
            print(f"step {it}: loss {float(loss):.6f}")
    if mesh.rank == 0:
        np.savez(args.output + "_recovered.npz",
                 density=params[0].detach().cpu().numpy())
        print(f"wrote {args.output}_recovered.npz")
    return 0


if __name__ == "__main__":
    sys.exit(main())
