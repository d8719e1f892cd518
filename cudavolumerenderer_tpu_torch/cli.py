"""Command-line entry point mirroring the reference's flags.

Port of cudavolumerenderer_tpu/cli.py (reference: Main.cpp:133,
ConfigParser.cpp:10-67): the same flag names and defaults, and the batch
"test" mode's trials/timing/Mrays protocol (Main.cpp:46-121).  The render
runs on the device `--platform` names (`cuda`, the default, or `cpu`);
asking for CUDA without a card is an error, never a CPU fallback.  Every
scheduler of `-k` renders.  `--interactive` is the headless progressive
mode: time-budgeted frame dumps, `--orbit N` frames circling the volume,
or a `--camera-path` script whose motion resets the accumulation.

Usage:
    python -m cudavolumerenderer_tpu_torch.cli scene.xml -k regenerationSK -i 4
"""

from __future__ import annotations

import argparse
import math
import sys
import time
from typing import List, Optional

import numpy as np
import torch

from .config import Algorithm, Config, Kernel, SceneType
from .models.renderer import create_renderer
from .ops.camera import make_camera_look_at
from .ops.camera_controller import CameraController, parse_camera_path
from .scene.loader import load_scene
from .scene.types import RenderSettings
from .utils.image import save_hdr, save_png, tonemap

PRINT_PREFIX = "[cvr-torch] "
# Interactive-mode per-frame refinement budget in seconds (reference:
# InteractiveRenderer.h:335-343 refines until >=0.1 s has elapsed).
FRAME_BUDGET_S = 0.1


def _flag(s: str) -> bool:
    return s.lower() in ("1", "true", "yes")


def _cascade_factor(v: str) -> float:
    f = float(v)
    if f <= 1.0:
        raise argparse.ArgumentTypeError(
            f"--cascade-factor must be > 1 (got {f}): values <= 1 "
            "would disable the cascade or divide by zero"
        )
    return f


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="cudavolumerenderer_tpu_torch",
        description="volumetric path tracer (PyTorch/CUDA port)",
    )
    p.add_argument("scene_file", nargs="?", help="scene file to parse")
    p.add_argument(
        "--scene-type", default="Auto",
        choices=["Auto", "MitsubaXml", "Vdb", "Raw", "Mhd", "Npz"],
    )
    p.add_argument(
        "--interactive", type=_flag, default=False,
        help="progressive mode with periodic frame dumps (offline "
        "replacement for the GLFW view)",
    )
    p.add_argument("--trials", type=int, default=1)
    p.add_argument("-a", "--algorithm", default="cudaVolPath")
    p.add_argument("-k", "--kernel", default="fastSK",
                   help="scheduler: " + ", ".join(k.value for k in Kernel))
    p.add_argument("--number-of-tiles", type=int, nargs="+", default=[1, 1])
    p.add_argument("-i", "--iterations", type=int, default=20)
    p.add_argument("-o", "--output", default=None)
    p.add_argument("-r", "--resolution", type=int, nargs="+",
                   default=[1024, 1024])
    p.add_argument("--seed", type=int, default=1234)
    p.add_argument(
        "--n-lanes", type=int, default=None,
        help="wavefront pool size for regeneration/streaming schedulers "
        "(default: sized from the work and device memory)",
    )
    p.add_argument("--regeneration-level", type=int, default=0,
                   choices=[0, 1, 2],
                   help="regenerationSK refill granularity: 0 = per lane "
                   "(thread), 1 = per 8-lane group (warp analog), 2 = per "
                   "1024-lane row (block analog)")
    p.add_argument("--mitsuba-comparable", type=_flag, default=True)
    p.add_argument(
        "--platform", default="cuda", choices=["cuda", "cpu"],
        help="device to render on; cuda needs a visible CUDA card",
    )
    p.add_argument("--two-level", action="store_true",
                   help="fastSK/fastQ: two-level sparse-leap tracking")
    p.add_argument("--lanes-per-pixel", type=int, default=1,
                   help="fastSK: parallel sample lanes per pixel")
    p.add_argument("--defer-ggx", type=int, default=0,
                   help="fastSK: deferred boundary events (flush every N)")
    p.add_argument("--brick-major", action="store_true",
                   help="fastSK: brick-major table layout")
    p.add_argument("--cascade-factor", type=_cascade_factor, default=2,
                   help="fastSK: cascade pool shrink factor (> 1)")
    p.add_argument("--table-bits", type=int, default=32, choices=[32, 8, 4],
                   help="fastSK: quantized density tables")
    p.add_argument(
        "--boundary", default="aabb", choices=["aabb", "variable"],
        help="medium boundary model: 'variable' = stochastic "
        "density-isosurface march with gradient shading normals "
        "(reference Medium.h VariableBoundary; integrator-family "
        "kernels only)",
    )
    p.add_argument("--boundary-threshold", type=float, default=1e-8,
                   help="gradient-magnitude threshold for --boundary variable")
    p.add_argument("--allow-quantized", action="store_true",
                   help="opt in to quantized tables under "
                   "--mitsuba-comparable")
    p.add_argument("--tail-single-level", action="store_true",
                   help="fastSK: single-level tail pools")
    p.add_argument("--tail-spec", type=int, default=1,
                   help="fastSK: speculative tail steps")
    p.add_argument("--spec-width", type=int, default=None,
                   help="fastSK: width for the spec/single-level tail modes")
    p.add_argument("--min-width", type=int, default=None,
                   help="fastSK: cascade bottom pool width")
    p.add_argument("--max-bricks", type=int, default=None,
                   help="fastSK: two-level probe-table size cap")
    p.add_argument("--tail-bricks", type=int, default=0,
                   help="fastSK: finer tail brick tables")
    p.add_argument("--tail-pallas", action="store_true",
                   help="fastSK: persistent tail kernel (csrc/tailpk.cu)")
    p.add_argument("--tail-pk-width", type=int, default=128)
    p.add_argument("--tail-pk-steps", type=int, default=16)
    p.add_argument(
        "--orbit", type=int, default=0, metavar="N",
        help="with --interactive: render N frames orbiting the volume "
        "(offline replacement for the GLFW rotate control)",
    )
    p.add_argument(
        "--camera-path", metavar="FILE", default=None,
        help="with --interactive: replay a scripted camera path "
        "(rotate/zoom/pan/lookat/render events; motion resets the "
        "progressive accumulation like the reference's mouse-dirty -> "
        "reset flow)",
    )
    return p


def config_from_args(args) -> Config:
    tiles = args.number_of_tiles
    if len(tiles) == 1:
        tiles = [tiles[0], tiles[0]]
    res = args.resolution
    if len(res) == 1:
        res = [res[0], res[0]]
    config = Config(
        scene_file=args.scene_file,
        scene_type=SceneType(args.scene_type),
        algorithm=Algorithm(args.algorithm),
        kernel=Kernel.from_name(args.kernel),
        iterations=args.iterations,
        resolution=(res[0], res[1]),
        n_tiles=(tiles[0], tiles[1]),
        trials=args.trials,
        interactive=args.interactive,
        output_name=args.output,
        seed=args.seed,
        n_lanes=args.n_lanes,
        regeneration_level=args.regeneration_level,
        two_level=args.two_level,
        lanes_per_pixel=args.lanes_per_pixel,
        defer_ggx=args.defer_ggx,
        brick_major=args.brick_major,
        cascade_factor=args.cascade_factor,
        table_bits=args.table_bits,
        allow_quantized=args.allow_quantized,
        tail_single_level=args.tail_single_level,
        tail_spec=args.tail_spec,
        spec_width=args.spec_width,
        min_width=args.min_width,
        max_bricks=args.max_bricks,
        tail_bricks=args.tail_bricks,
        tail_pallas=args.tail_pallas,
        tail_pk_width=args.tail_pk_width,
        tail_pk_steps=args.tail_pk_steps,
        settings=RenderSettings.from_flags(
            args.mitsuba_comparable,
            boundary=args.boundary,
            boundary_threshold=args.boundary_threshold,
        ),
    )
    if config.output_name is None:
        config.output_name = config.to_string()
    return config


def device_of(platform: str) -> torch.device:
    """The render device for --platform; CUDA must be present if asked."""
    if platform == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "--platform cuda: torch.cuda.is_available() is False; pass "
            "--platform cpu to render on the CPU"
        )
    return torch.device(platform)


def run_test(config: Config, device) -> dict:
    """Batch benchmark mode (reference: runTest, Main.cpp:46-121): N
    trials on `device`, discard-first-trial mean/std, paths/s and Mrays/s.
    Each trial fences on the n_rays readback and copies the image to the
    host after the timed region, as the JAX package does; the result also
    carries the mean time with that copy (`mean_time_with_copy`)."""
    times: List[float] = []
    copy_times: List[float] = []
    rays: List[float] = []
    for trial in range(config.trials):
        print(f"{PRINT_PREFIX}--- trial {trial}")
        t0 = time.time()
        scene, camera = load_scene(config, device=device)
        renderer = create_renderer(scene, camera, config)
        t1 = time.time()
        print(f"{PRINT_PREFIX}initialization time : {t1 - t0:.2f} sec")

        t0 = time.time()
        renderer.render_device()
        n_rays = renderer.n_rays  # on-device scalar readback = full fence
        t1 = time.time()
        image = renderer.get_image()
        with_copy = time.time() - t0
        elapsed = t1 - t0
        print(f"{PRINT_PREFIX}rendering time      : {elapsed:.2f} sec")
        if trial > 0 or config.trials == 1:
            times.append(elapsed)
            copy_times.append(with_copy)
            rays.append(n_rays)

        save_hdr(config.output_name + ".hdr", image)
        save_png(config.output_name + ".png", tonemap(image))

    mean_time = float(np.mean(times))
    std_time = float(np.std(times))
    n_paths = config.resolution[0] * config.resolution[1] * config.iterations
    mrays = float(np.mean(rays)) / (mean_time * 1e6)
    print(
        f"{PRINT_PREFIX}execution mean time of {mean_time:.2f} sec on "
        f"{len(times)} trials and std {std_time:.5f}"
    )
    print(f"{PRINT_PREFIX}paths per sec {n_paths / mean_time:.0f}")
    print(f"{PRINT_PREFIX}millions of rays per sec {mrays:.3f}")
    return dict(
        mean_time=mean_time, std_time=std_time,
        paths_per_sec=n_paths / mean_time, mrays_per_sec=mrays,
        n_rays=float(np.mean(rays)),
        mean_time_with_copy=float(np.mean(copy_times)),
    )


def run_camera_path(config: Config, path_file: str, device) -> None:
    """Scripted interactive-camera replay: rotate/zoom/pan events drive
    the quaternion CameraController (Camera.h:74-122 dynamics) and any
    motion resets the progressive accumulation before the next render,
    the InputController dirty-flag -> reset() -> initRendering flow
    (InteractiveRenderer.h:102,251-282,314-317), minus the GLFW window.
    Writes one PNG frame per render event."""
    scene, _ = load_scene(config, device=device)
    w, h = config.resolution
    with open(path_file) as f:
        events = parse_camera_path(f.read())
    ctl = CameraController(w, h, fov_x_deg=0.7)
    renderer = create_renderer(scene, ctl.camera(device), config)
    frame = 0
    for op, args in events:
        if op == "rotate":
            ctl.rotate(*args)
        elif op == "zoom":
            ctl.zoom(*args)
        elif op == "pan":
            ctl.pan(*args)
        elif op == "lookat":
            ctl.look_at(args[0:3], args[3:6], (0.0, 1.0, 0.0))
        elif op == "render":
            if ctl.consume_dirty():
                # motion invalidates the accumulated image: rebuild the
                # camera and restart accumulation (reference reset())
                renderer.camera = ctl.camera(device)
                renderer.init_rendering()
                print(f"{PRINT_PREFIX}camera moved, accumulation reset")
            for _ in range(args[0]):
                renderer.run_pass(1)
            frame += 1
            save_png(
                f"{config.output_name}_path{frame:04d}.png",
                tonemap(renderer.get_image()),
            )
            print(
                f"{PRINT_PREFIX}path frame {frame} dumped "
                f"({int(renderer.iterations_done.min())} it)"
            )


def run_interactive(config: Config, device, orbit: int = 0) -> None:
    """Offline progressive mode: refine and dump frames periodically
    (replaces GLViewController's 0.1 s refinement budget loop,
    InteractiveRenderer.h:319-349), then write the final .hdr.  With
    orbit > 0, N frames circle the volume instead, each a full render
    (the offline stand-in for the reference's mouse rotate/zoom)."""
    scene, camera = load_scene(config, device=device)

    if orbit > 0:
        radius = 100.0
        w, h = config.resolution
        for frame in range(orbit):
            angle = 2.0 * math.pi * frame / orbit
            eye = (radius * math.sin(angle), 0.0, radius * math.cos(angle))
            cam_f = make_camera_look_at(
                eye, (0.0, 0.0, 0.0), (0.0, 1.0, 0.0), w, h, 0.7,
                device=device,
            )
            img = create_renderer(scene, cam_f, config).render()
            save_png(f"{config.output_name}_orbit{frame:04d}.png", tonemap(img))
            print(f"{PRINT_PREFIX}orbit frame {frame} dumped")
        return

    renderer = create_renderer(scene, camera, config)
    frame = 0
    while not renderer.image_complete():
        # time-budgeted refinement (InteractiveRenderer.h:335-343: repeat
        # runIterations + getImage until >= 0.1 s has elapsed); each
        # inner pass is one sample of every pixel
        t0 = time.time()
        while True:
            renderer.run_pass(1)
            if time.time() - t0 >= FRAME_BUDGET_S or renderer.image_complete():
                break
        frame += 1
        save_png(
            f"{config.output_name}_frame{frame:04d}.png",
            tonemap(renderer.get_image()),
        )
        print(f"{PRINT_PREFIX}frame {frame} dumped")
    save_hdr(config.output_name + ".hdr", renderer.get_image())


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    if args.scene_file is None:
        build_parser().print_help()
        return 2
    config = config_from_args(args)
    device = device_of(args.platform)
    print(f"{PRINT_PREFIX}algorithm set to {config.algorithm.value}.")
    print(f"{PRINT_PREFIX}kernel set to {config.kernel.value}.")
    print(f"{PRINT_PREFIX}iterations set to {config.iterations}.")
    if config.interactive and args.camera_path:
        run_camera_path(config, args.camera_path, device)
    elif config.interactive:
        run_interactive(config, device, orbit=args.orbit)
    else:
        run_test(config, device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
