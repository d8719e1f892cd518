"""The north-star configuration: a 1024^3 sparse (VDB-class) volume at
1024x1024 with fastSK, and render_diff's forward+backward on it (port of
benchmarks/bench_1024.py, with its flags, defaults and output lines).

The grid is made on the device (a 4.3 GB density never crosses from the
host): a plume with hard zeros outside (~10% occupancy) and a 32-bit hash
noise per 64^3 block, constant albedo 0.9 (the fused table stays
density-only), scale 100.  Reports the forward's Mrays/s through
fast.render_tile; with --bwd also the seconds of render_diff's
forward+backward (the two-level replay, on the card csrc/replaybody.cu)
on a reduced pixel budget, and its primal alone.

    python -m cudavolumerenderer_tpu_torch.benchmarks.bench_1024 \\
        [--platform cuda|cpu] [--n 1024] [--res 1024] [--iters 4] [--bwd] \\
        [--bwd-res R] [--bwd-spp 1] [--no-fwd] [--brick-major] \\
        [--defer-ggx G] [--min-width W] [--table-bits 32|8|4] \\
        [--max-bricks B] [--brick-size bz by bx] [--cascade-factor F] \\
        [--bwd-no-cascade]

`--platform cuda` (the default) runs on the card and raises without one;
`--platform cpu` runs on the CPU, for checking at a small size (--n 32
--res 32).  Every line that states a time or a rate ends with the
device: the card's name and power limit as nvidia-smi reports them.
`main(argv)` returns the numbers as a dict, with the card's peak
allocated memory (torch.cuda.max_memory_allocated; None on the CPU).  The
JAX script donates the grid to its gradient program; here the grid is
made anew for each timed rep and each gradient is dropped after its sum
is read.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time

import numpy as np
import torch

from ..cli import device_of
from ..config import Config
from ..models import fast
from ..models.differentiable import CameraSpec, SceneSpec, render_diff
from ..ops.camera import make_camera
from ..ops.rng import M32, mul32
from ..scene.types import RenderSettings, make_medium, make_scene

#: z-planes of the grid made per pass (bounds the int64 hash temporaries)
SLAB = 64


def _axis(n: int):
    """The grid's coordinates along one axis as jnp.linspace(0, 1, n) makes
    them (i / (n - 1) in float32, the last exactly 1), and the hash's cell
    index (coord * (n - 1)) truncated to an integer, as float32 arithmetic
    on the host."""
    div = np.float32(max(n - 1, 1))
    c = np.arange(n, dtype=np.float32) / div
    if n > 1:
        c[-1] = np.float32(1.0)
    cell = (c * np.float32(n - 1)).astype(np.int64)
    return c, cell


def make_density_1024(n: int = 1024, device="cuda") -> torch.Tensor:
    """The (n, n, n) float32 plume of the JAX script, made on `device` in
    slabs of SLAB z-planes: base = exp(-r2 / (0.02 + 0.12 z)) (1 - 0.55 z)
    with r2 the squared distance from the column's axis, times
    (0.55 + 0.45 noise) less 0.25, clamped at 0; the noise a 32-bit hash of
    the 64^3 block (uint32 words held in int64, as ops/rng holds them)."""
    device = torch.device(device)
    c, cell = _axis(n)
    coord = torch.from_numpy(c).to(device)
    block = torch.from_numpy(cell // 64).to(device)
    hz = mul32(block, 0x9E3779B9)
    hy = mul32(block, 0x85EBCA6B)
    hx = mul32(block, 0xC2B2AE35)
    x = coord.reshape(1, 1, -1)
    y = coord.reshape(1, -1, 1)
    r2 = (x - 0.5) ** 2 + (y - 0.5) ** 2
    out = torch.empty((n, n, n), dtype=torch.float32, device=device)
    for z0 in range(0, n, SLAB):
        z = coord[z0:z0 + SLAB].reshape(-1, 1, 1)
        base = torch.exp(-r2 / (0.02 + 0.12 * z)) * (1.0 - 0.55 * z)
        h = (hz[z0:z0 + SLAB].reshape(-1, 1, 1) ^ hy.reshape(1, -1, 1)
             ^ hx.reshape(1, 1, -1))
        h = h ^ (h >> 15)
        h = mul32(h, 0x2C1B3C6D)
        h = (h ^ (h >> 12)) & M32
        noise = (h >> 8).to(torch.float32) * (1.0 / (1 << 24))
        d = base * (0.55 + 0.45 * noise) - 0.25
        out[z0:z0 + SLAB] = torch.clamp(d, min=0.0)
    return out


def device_line(dev: torch.device) -> str:
    """The card's name and power limit as nvidia-smi reports them (the
    name alone where nvidia-smi does not answer), or "cpu"."""
    if dev.type != "cuda":
        return "cpu"
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", f"--id={dev.index or 0}"],
            capture_output=True, text=True, check=True, timeout=60)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return f"{torch.cuda.get_device_name(dev)}, power limit not read"


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m cudavolumerenderer_tpu_torch.benchmarks.bench_1024")
    ap.add_argument("--platform", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--n", type=int, default=1024)
    ap.add_argument("--res", type=int, default=1024)
    ap.add_argument("--iters", type=int, default=4)
    ap.add_argument("--bwd", action="store_true")
    ap.add_argument(
        "--bwd-res", type=int, default=None,
        help="pixel width for the fwd+bwd measurement (default res//4)")
    ap.add_argument("--bwd-spp", type=int, default=1)
    ap.add_argument("--no-fwd", action="store_true",
                    help="skip the forward block (bwd-only runs)")
    ap.add_argument(
        "--brick-major", action="store_true",
        help="8^3 brick-major flat-table layout (texture-locality analog)")
    ap.add_argument("--defer-ggx", type=int, default=0)
    ap.add_argument("--min-width", type=int, default=None)
    ap.add_argument("--table-bits", type=int, default=32, choices=[32, 8, 4],
                    help="quantized packed density table: 4.3 GB f32 -> "
                    "1.07 GB (8) / 537 MB (4); routed through "
                    "Config.effective_table_bits with the explicit opt-in "
                    "(reduced precision)")
    ap.add_argument(
        "--max-bricks", type=int, default=None,
        help="majorant-grid granularity cap (fast.pick_brick budget)")
    ap.add_argument("--brick-size", type=int, nargs=3, default=None,
                    help="explicit (bz by bx) brick size override")
    ap.add_argument("--cascade-factor", type=float, default=2)
    ap.add_argument(
        "--bwd-no-cascade", action="store_true",
        help="A/B: run the backward with the single-pool fused replay "
        "instead of the cascaded one")
    return ap.parse_args(argv)


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def forward(args, scene, dev, line: str) -> dict:
    """The forward block: one with_stats render and its stage lines, then
    two timed seeds (the image copied to the host)."""
    res = args.res
    settings = RenderSettings.from_flags(True)
    eff_bits = Config(table_bits=args.table_bits, allow_quantized=True,
                      settings=settings).effective_table_bits
    kw = dict(
        scene=scene, camera=make_camera(res, res, device=dev),
        settings=settings, tile_dim=(res, res),
        tile_offset=torch.zeros(2, dtype=torch.float32, device=dev),
        full_resolution=(res, res), spp=args.iters, two_level=True,
        with_stats=True, brick_major=args.brick_major,
        defer_ggx=args.defer_ggx, table_bits=eff_bits,
        min_width=args.min_width, cascade_factor=args.cascade_factor,
    )
    if args.max_bricks is not None:
        kw["max_bricks"] = args.max_bricks
    if args.brick_size is not None:
        kw["brick_size"] = tuple(args.brick_size)
    out = fast.render_tile(seed=1, path_id_base=0, **kw)
    _ = float(out[0].sum())
    n_rays, n_rows, n_busy = (float(x) for x in out[1:4])
    stage_rows = [float(x) for x in out[4]]
    widths = fast._cascade_widths(res * res, args.cascade_factor,
                                  args.min_width or fast._MIN_WIDTH)
    print(f"stats: rays={n_rays:.0f} rows={n_rows:.0f} "
          f"busy={n_busy / max(n_rows, 1):.3f} "
          f"width_equiv={n_rows / (res * res):.0f}", flush=True)
    for w, r in zip(widths, stage_rows):
        print(f"  stage w={w:8d}: iters={r / w:7.0f} "
              f"width_equiv={r / (res * res):6.1f}", flush=True)
    seconds, rates = [], []
    for s in (7, 8):
        _sync(dev)
        t0 = time.perf_counter()
        out = fast.render_tile(seed=s, path_id_base=0, **kw)
        img = out[0].cpu()
        _ = float(img.sum())
        dt = time.perf_counter() - t0
        mrays = float(out[1]) / dt / 1e6
        seconds.append(dt)
        rates.append(mrays)
        print(f"fwd seed={s}: {dt:.3f}s  {mrays:.2f} Mrays/s; {line}",
              flush=True)
    best = max(rates)
    print(f"BEST fwd: {best:.2f} Mrays/s ({args.n}^3, {res}^2, "
          f"{args.iters} it); {line}", flush=True)
    return {"n_rays": n_rays, "n_rows": n_rows, "n_busy": n_busy,
            "stage_rows": stage_rows, "fwd_s": seconds, "fwd_mrays": rates,
            "best_mrays": best}


def backward(args, scene, density, dmax: float, dev, line: str) -> dict:
    """The --bwd block: the ray count of the workload, the primal replay
    alone, and two timed forward+backward seeds, each on a grid made anew
    and ended by the gradient's sum read to the host."""
    knobs = {"cascade_factor": args.cascade_factor}
    if args.bwd_no_cascade:
        knobs["cascade"] = False
        print("bwd: cascade DISABLED (single-pool fused replay)", flush=True)
    if args.max_bricks is not None:
        knobs["max_bricks"] = args.max_bricks
        print(f"bwd: DIFF_MAX_BRICKS={args.max_bricks}", flush=True)
    if args.cascade_factor != 2:
        print(f"bwd: DIFF_CASCADE_FACTOR={args.cascade_factor}", flush=True)

    bres = args.bwd_res or args.res // 4
    bspp = args.bwd_spp
    spec = SceneSpec(scale=100.0, max_density=dmax)
    cam = CameraSpec(res_x=bres, res_y=bres, fov_x_deg=0.7)
    dsettings = RenderSettings.from_flags(
        True, russian_roulette=True, max_path_length=100)
    albedo_grid = torch.full((1, 1, 1, 4), 0.9, dtype=torch.float32,
                             device=dev)

    # Ray count of the fwd+bwd workload: the replay re-traces the same
    # two-level estimator family, so the forward's segment count at the
    # same (res, spp, settings) is the estimate's ray segments (each then
    # traced by the primal and by pass B, pass A being elided; the lines
    # keep the JAX script's "x3 passes" and "traced" rate).
    camera = make_camera(args.res, args.res, device=dev)
    cimg, cnr = fast.render_tile(
        scene, camera, dsettings, (bres, bres),
        torch.zeros(2, dtype=torch.float32, device=dev), (bres, bres), bspp,
        4, 0, two_level=True)
    _ = float(cimg.sum())
    n_rays_bwd = float(cnr)
    n_paths = bres * bres * bspp
    print(f"bwd workload: {bres}^2 x {bspp} spp = {n_paths} paths, "
          f"~{n_rays_bwd:.0f} rays/estimate "
          f"({n_rays_bwd / n_paths:.1f} bounces/path)", flush=True)

    def render(grid, seed, stats=None):
        return render_diff(grid, albedo_grid, seed, spec, cam, dsettings,
                           (bres, bres), bspp, True, stats=stats, **knobs)

    # anatomy: one replay's worth (the primal) alone
    with torch.no_grad():
        _ = float(render(density, 2).sum())
        _sync(dev)
        t0 = time.perf_counter()
        _ = float(render(density, 3).sum())
        t_prim = time.perf_counter() - t0
    print(f"primal replay alone: {t_prim:.3f}s "
          f"({n_rays_bwd / t_prim / 1e6:.2f} Mrays/s); {line}", flush=True)

    def value_and_grad(grid, seed, stats=None):
        grid = grid.detach().requires_grad_(True)
        val = torch.mean(render(grid, seed, stats))
        (g,) = torch.autograd.grad(val, grid)
        return val.detach(), g

    val, g = value_and_grad(density, 3)
    _ = float(val), float(g.sum())
    del g
    reps = []
    for s in (4, 5):
        dgrid = make_density_1024(args.n, dev)
        stats = {}
        _sync(dev)
        t0 = time.perf_counter()
        val, g = value_and_grad(dgrid, s, stats)
        gs = float(g.sum())
        dt = time.perf_counter() - t0
        del g, dgrid
        reps.append({"seed": s, "s": dt, "loss": float(val), "gsum": gs,
                     "primal_iters": stats["primal_iters"][0],
                     "pass_b_iters": stats["pass_b_iters"][0]})
        print(f"fwd+bwd seed={s}: {dt:.3f}s  {n_paths / dt / 1e6:.3f} "
              f"Mpaths/s  {n_rays_bwd / dt / 1e6:.2f} Mrays/s (effective)  "
              f"{3 * n_rays_bwd / dt / 1e6:.2f} Mrays/s (traced)  "
              f"loss={float(val):.4f} gsum={gs:.3e}; {line}", flush=True)
        print(f"  anatomy: primal {t_prim:.3f}s x3 passes ~{3 * t_prim:.3f}s "
              f"vs total {dt:.3f}s -> adjoint-scatter overhead "
              f"~{dt - 3 * t_prim:.3f}s; replay iterations primal "
              f"{reps[-1]['primal_iters']}, pass B "
              f"{reps[-1]['pass_b_iters']}; {line}", flush=True)
    return {"bwd_res": bres, "bwd_spp": bspp, "n_paths": n_paths,
            "n_rays_bwd": n_rays_bwd, "primal_s": t_prim, "fwdbwd": reps}


def main(argv=None) -> dict:
    """Run the blocks the flags ask for; print the JAX script's lines and
    return the numbers."""
    args = parse_args(argv)
    dev = device_of(args.platform)
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.reset_peak_memory_stats(dev)
    line = device_line(dev)

    t0 = time.perf_counter()
    density = make_density_1024(args.n, dev)
    _sync(dev)
    t_grid = time.perf_counter() - t0
    occ = float(torch.count_nonzero(density)) / density.numel()
    dmax = float(density.max())
    print(f"grid {args.n}^3  occupancy={occ * 100:.1f}%  max={dmax:.3f}  "
          f"(made in {t_grid:.2f}s; {line})", flush=True)
    scene = make_scene(make_medium(density, (0.9, 0.9, 0.9), scale=100.0,
                                   max_density=dmax, device=dev))
    result = {"device": line, "n": args.n, "res": args.res,
              "iters": args.iters, "occupancy": occ, "max_density": dmax,
              "grid_s": t_grid}
    if not args.no_fwd:
        result.update(forward(args, scene, dev, line))
    if args.bwd:
        result.update(backward(args, scene, density, dmax, dev, line))
    result["max_memory_allocated"] = (
        torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None)
    if dev.type == "cuda":
        print(f"peak allocated {result['max_memory_allocated'] / 2**30:.2f} "
              f"GiB; {line}", flush=True)
    return result


if __name__ == "__main__":
    main()
    sys.exit(0)
