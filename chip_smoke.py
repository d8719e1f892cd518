#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (cudavolumerenderer_tpu_torch) on
one CUDA card.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; nothing falls back to the
CPU or to a plain version on a CUDA tensor):

1. identify the card (nvidia-smi name and power limit); refuse to run
   without CUDA;
2. build both kernels, csrc/tailpk.cu and csrc/tracking.cu, with one nvcc
   each, started together (into the package's ignored _build/
   directory); print the build times and ptxas registers and spills;
3. the kernel against its plain torch version on the card, on the
   medical 256^3 dilated-brick table with R = 128 and R = 4096 paths at
   K = 16 steps: integer outputs equal on >= 99.9% of paths, floats
   allclose (rtol 1e-5, atol 1e-6) on those; both timed with CUDA events;
4. white furnace through the kernel (every pixel == spp, rtol 2e-5), and
   a small render on the card against the same render on the CPU;
5. the slice: BASELINE config 2 (medical 256^3 MHD, red-channel albedo,
   scale 100, 512^2 x 4 iterations, one tile) through load_scene and
   create_renderer(...).render() with fastSK two-level and the tail
   kernel on; one warm-up render, then one timed render including the
   image copy to the host; the kernel's launch count must rise;
6. the tracking kernel against its plain torch version on the brickSK
   slice's own dilated table (smoke 128x128x50, scale 800) with R = 8
   and R = 1,250 rows at K = 8 and K = 32 steps: integer outputs equal on
   >= 99.9% of lanes, t allclose (rtol 1e-5, atol 1e-6) on those; both
   timed with CUDA events;
7. white furnace through brickSK on the card (every pixel == spp), and a
   small brickSK render on the card against the same render on the CPU;
8. the brickSK slice (the smoke class of benchmarks/micro_smoke_brick.py:
   smoke 128x128x50, albedo 0.9 d, scale 800, written as Mitsuba XML +
   .vol files like BASELINE config 4) through the CLI's batch mode:
   -k brickSK -i 4 -r 400 400, two trials (the first discarded); the
   tracking kernel's launch count must rise; then one timed render
   through brick.render_tile (the function make_kernel_fn returns),
   image copied to the host, with its round count.

The last lines are a JSON line describing the kernels, the card's name
and power limit, and the result line {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

RTOL, ATOL = 1e-5, 1e-6
N_STEPS = 16
SLICE_XML = """<scene version="0.5.0">
  <medium type="heterogeneous" id="smoke">
    <volume name="density" type="gridvolume">
      <string name="filename" value="density.vol"/>
    </volume>
    <volume name="albedo" type="gridvolume">
      <string name="filename" value="albedo.vol"/>
    </volume>
    <float name="scale" value="800"/>
  </medium>
  <sensor type="perspective">
    <float name="fov" value="0.7"/>
    <film type="hdrfilm">
      <integer name="width" value="400"/>
      <integer name="height" value="400"/>
    </film>
  </sensor>
</scene>
"""


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip()


def write_medical_mhd(tmp: str) -> str:
    """BASELINE config 2's scene file (benchmarks/baseline_configs.py
    _write_medical_mhd): 256^3 CT-style u16 counts, min-max normalized and
    smoothstepped by the loader."""
    from cudavolumerenderer_tpu_torch.scene import procedural

    n = 256
    d = procedural.medical_volume((n, n, n), n_blobs=40)
    raw_path = os.path.join(tmp, "medical_synth.raw")
    (d * 4095.0).astype("<u2").tofile(raw_path)
    mhd_path = os.path.join(tmp, "medical_synth.mhd")
    with open(mhd_path, "w") as f:
        f.write(
            "ObjectType = Image\nNDims = 3\nBinaryData = True\n"
            "BinaryDataByteOrderMSB = False\n"
            f"DimSize = {n} {n} {n}\n"
            "ElementType = MET_USHORT\n"
            "ElementSpacing = 1 1 1\n"
            f"ElementDataFile = {os.path.basename(raw_path)}\n"
        )
    return mhd_path


def write_smoke_xml(tmp: str) -> str:
    """The brickSK slice's scene files: smoke_volume((128, 128, 50)) and an
    RGB albedo of 0.9 * density over [-0.5, 0.5]^3, scale 800, fov 0.7,
    a 400x400 film (benchmarks/baseline_configs.py _write_mitsuba_xml's
    files, at micro_smoke_brick.py's scale)."""
    from cudavolumerenderer_tpu_torch.scene import procedural
    from cudavolumerenderer_tpu_torch.scene.vol import write_vol

    d = procedural.smoke_volume((128, 128, 50)).astype(np.float32)
    alb = (np.stack([d, d, d], axis=-1) * 0.9).astype(np.float32)
    box = ((-0.5, -0.5, -0.5), (0.5, 0.5, 0.5))
    write_vol(os.path.join(tmp, "density.vol"), d, *box)
    write_vol(os.path.join(tmp, "albedo.vol"), alb, *box)
    path = os.path.join(tmp, "smoke_scene.xml")
    with open(path, "w") as f:
        f.write(SLICE_XML)
    return path


def cuda_ms(fn, reps: int, warmup: int) -> float:
    """Mean milliseconds per call of fn, CUDA events around reps calls."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def kernel_vs_plain(tables, params, n_paths: int):
    """Phase 3 at one width: returns (max_abs_err, kernel ms, plain ms)."""
    import torch

    from cudavolumerenderer_tpu_torch.ops import tailpk as tpk

    inputs = tpk.random_tail_state(tables, params, n_paths, seed=n_paths)
    args = (tables.tab, *inputs[:1], params, *inputs[1:])
    got = tpk.run_tail_steps(*args, n_steps=N_STEPS)
    torch.cuda.synchronize()
    want = tpk.tail_steps(*args, n_steps=N_STEPS)
    (gf, gi, gs), (wf, wi, ws) = (
        [x.cpu().numpy() for x in got], [x.cpu().numpy() for x in want]
    )
    agree = (gi == wi).all(axis=0) & (gs == ws)
    n_diff = int((~agree).sum())
    statuses = np.bincount(gi[1], minlength=4).tolist()
    log(f"[3] R={n_paths} K={N_STEPS}: paths differing {n_diff}/{n_paths}; "
        f"status RUN/NEED_WINDOW/EXIT_BOX/DEAD = {statuses}")
    check(agree.mean() >= 0.999, f"R={n_paths}: {n_diff} paths differ")
    a, b = gf[:, agree], wf[:, agree]
    fin = np.isfinite(a) & np.isfinite(b)
    check(np.array_equal(a[~fin], b[~fin], equal_nan=True),
          f"R={n_paths}: non-finite outputs differ")
    np.testing.assert_allclose(a[fin], b[fin], rtol=RTOL, atol=ATOL)
    err = float(np.max(np.abs(a[fin] - b[fin]), initial=0.0))
    ms = cuda_ms(lambda: tpk.run_tail_steps(*args, n_steps=N_STEPS), 200, 5)
    plain_ms = cuda_ms(lambda: tpk.tail_steps(*args, n_steps=N_STEPS), 10, 2)
    log(f"[3] R={n_paths}: kernel {ms:.4f} ms, plain torch {plain_ms:.4f} ms "
        f"per {N_STEPS}-step call; max |err| {err:.3g}")
    return err, ms, plain_ms


def furnace_and_small_render():
    """Phase 4: exact white furnace through the kernel, then a small
    medical render on the card against the CPU (plain-version) render."""
    import torch

    from cudavolumerenderer_tpu_torch.models import fast
    from cudavolumerenderer_tpu_torch.ops import tailpk as tpk
    from cudavolumerenderer_tpu_torch.ops.camera import make_camera
    from cudavolumerenderer_tpu_torch.scene import procedural
    from cudavolumerenderer_tpu_torch.scene.types import (
        RenderSettings, make_medium, make_scene,
    )

    tail = dict(two_level=True, tail_pallas=True, tail_pk_width=16,
                tail_pk_steps=8, min_width=32)
    d = procedural.blob_volume((24, 24, 24), n_blobs=3)
    scene = make_scene(make_medium(d, 1.0, scale=8.0, max_density=1.0,
                                   device="cuda"))
    settings = RenderSettings.from_flags(
        True, russian_roulette=False, max_path_length=200, bsdf_kind="null")
    before = tpk.KERNEL.launches
    img, _ = fast.render_tile(
        scene, make_camera(6, 6, device="cuda"), settings, (6, 6),
        torch.zeros(2, device="cuda"), (6, 6), 2, 3, 0, **tail)
    img = img.cpu().numpy()
    launched = tpk.KERNEL.launches - before
    check(launched > 0, "white furnace launched no tail kernel")
    np.testing.assert_allclose(img, 2.0, rtol=2e-5)
    log(f"[4] white furnace exact through the kernel ({launched} launches)")

    d = procedural.medical_volume((24, 24, 24), n_blobs=6)
    albedo = np.zeros(d.shape + (3,), np.float32)
    albedo[..., 0] = d
    settings = RenderSettings.from_flags(True, max_path_length=64)
    imgs = []
    for dev in ("cuda", "cpu"):
        scene = make_scene(make_medium(d, albedo, scale=30.0, max_density=1.0,
                                       device=dev))
        img, _ = fast.render_tile(
            scene, make_camera(8, 8, device=dev), settings, (8, 8),
            torch.zeros(2, device=dev), (8, 8), 32, 5, 0, **tail)
        imgs.append(img.cpu().numpy() / 32)
    a, b = imgs
    share = float(np.mean(np.abs(a - b) < 1e-4))
    log(f"[4] small render card vs CPU: means {a.mean():.5f} / {b.mean():.5f}, "
        f"max |diff| {np.abs(a - b).max():.4f}, pixels equal within 1e-4 "
        f"{share:.3f}")
    check(np.isfinite(a).all(), "small render not finite")
    check(abs(a.mean() - b.mean()) < 0.02 and np.abs(a - b).max() < 0.25,
          "small render on the card disagrees with the CPU render")


def track_vs_plain(tables, major, n_rows: int, n_steps: int):
    """Phase 6 at one shape: returns (max_abs_err, kernel ms, plain ms)."""
    import torch

    from cudavolumerenderer_tpu_torch.ops import tracking as tk

    inputs = tk.random_track_state(
        major, n_rows, seed=n_rows + n_steps, scale=800.0,
        vox_per_unit=(127.0, 127.0, 49.0),
    )
    args = (tables, *inputs)
    got = tk.run_track_steps(*args, n_steps=n_steps)
    torch.cuda.synchronize()
    want = tk.track_steps(*args, n_steps=n_steps)
    (gt, gs, gtap, gst), (wt, ws, wtap, wst) = (
        [x.cpu().numpy() for x in got], [x.cpu().numpy() for x in want]
    )
    agree = (gs == ws) & (gtap == wtap) & (gst == wst)
    n_diff = int((~agree).sum())
    statuses = np.bincount(gs.ravel(), minlength=5).tolist()
    log(f"[6] R={n_rows} K={n_steps}: lanes differing {n_diff}/{agree.size}; "
        f"status RUNNING/SCATTER/EXIT_BRICK/EXIT_BOX/other = {statuses}")
    check(agree.mean() >= 0.999, f"R={n_rows} K={n_steps}: {n_diff} lanes differ")
    a, b = gt[agree], wt[agree]
    fin = np.isfinite(a) & np.isfinite(b)
    check(np.array_equal(a[~fin], b[~fin], equal_nan=True),
          f"R={n_rows}: non-finite outputs differ")
    np.testing.assert_allclose(a[fin], b[fin], rtol=RTOL, atol=ATOL)
    err = float(np.max(np.abs(a[fin] - b[fin]), initial=0.0))
    ms = cuda_ms(lambda: tk.run_track_steps(*args, n_steps=n_steps), 200, 5)
    plain_ms = cuda_ms(lambda: tk.track_steps(*args, n_steps=n_steps), 10, 2)
    log(f"[6] R={n_rows} K={n_steps}: kernel {ms:.4f} ms, plain torch "
        f"{plain_ms:.4f} ms per call; max |err| {err:.3g}")
    return err, ms, plain_ms


def brick_furnace_and_small_render():
    """Phase 7: exact white furnace through brickSK on the card, then a
    small smoke render on the card against the CPU (plain-version)
    render."""
    import torch

    from cudavolumerenderer_tpu_torch.models import brick
    from cudavolumerenderer_tpu_torch.ops import tracking as tk
    from cudavolumerenderer_tpu_torch.ops.camera import make_camera
    from cudavolumerenderer_tpu_torch.scene import procedural
    from cudavolumerenderer_tpu_torch.scene.types import (
        RenderSettings, make_medium, make_scene,
    )

    d = procedural.blob_volume((24, 24, 24), n_blobs=3)
    scene = make_scene(make_medium(d, 1.0, scale=8.0, max_density=1.0,
                                   device="cuda"))
    settings = RenderSettings.from_flags(
        True, russian_roulette=False, bsdf_kind="null")
    before = tk.KERNEL.launches
    img, _, rounds = brick.render_tile(
        scene, make_camera(16, 16, device="cuda"), settings, (16, 16),
        torch.zeros(2, device="cuda"), (16, 16), 2, 3, 0, with_stats=True)
    img = img.cpu().numpy()
    launched = tk.KERNEL.launches - before
    check(launched == rounds > 0, f"{launched} launches in {rounds} rounds")
    check(np.array_equal(img, np.full_like(img, 2.0)),
          "brickSK white furnace not exact")
    log(f"[7] brickSK white furnace exact ({rounds} rounds, {launched} "
        "launches)")

    d = procedural.smoke_volume((32, 32, 16))
    alb = np.stack([d, d, d], axis=-1) * 0.9
    out = []
    for dev in ("cuda", "cpu"):
        scene = make_scene(make_medium(d, alb, scale=800.0,
                                       max_density=float(d.max()), device=dev))
        img, n_rays, rounds = brick.render_tile(
            scene, make_camera(16, 16, device=dev), RenderSettings(),
            (16, 16), torch.zeros(2, device=dev), (16, 16), 2, 5, 0,
            with_stats=True)
        out.append((img.cpu().numpy() / 2, float(n_rays), rounds))
    (a, ra, na), (b, rb, nb) = out
    share = float(np.mean(np.abs(a - b) < 1e-4))
    log(f"[7] small brickSK render card vs CPU: means {a.mean():.5f} / "
        f"{b.mean():.5f}, rays {ra:.0f} / {rb:.0f}, rounds {na} / {nb}, "
        f"pixels equal within 1e-4 {share:.3f}")
    check(np.isfinite(a).all(), "small brickSK render not finite")
    check(abs(a.mean() - b.mean()) < 0.02 and abs(ra - rb) <= 0.01 * rb,
          "small brickSK render on the card disagrees with the CPU render")


def main() -> int:
    import torch

    # -- phase 1: the card --------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs "
              "a CUDA card", file=sys.stderr)
        return 1
    card = card_line()
    log(f"[1] card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    from cudavolumerenderer_tpu_torch import cli
    from cudavolumerenderer_tpu_torch.config import Config, Kernel
    from cudavolumerenderer_tpu_torch.models import fast
    from cudavolumerenderer_tpu_torch.models.renderer import (
        create_renderer, make_kernel_fn,
    )
    from cudavolumerenderer_tpu_torch.ops import tailpk as tpk
    from cudavolumerenderer_tpu_torch.ops import tracking as tk
    from cudavolumerenderer_tpu_torch.scene.loader import load_scene
    from cudavolumerenderer_tpu_torch.utils.image import load_hdr

    # -- phase 2: build both kernels, one nvcc each, started together ------
    with ThreadPoolExecutor(2) as pool:
        builds = [pool.submit(k.library) for k in (tpk.KERNEL, tk.KERNEL)]
        builds = [b.result() for b in builds]
    for built in builds:
        log(f"[2] built {os.path.relpath(built.path)} in {built.seconds:.2f} s")
        for line in built.log.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[2] ptxas: {line.strip()}")

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        cfg = Config(
            scene_file=write_medical_mhd(tmp), kernel=Kernel.FAST_SK,
            two_level=True, tail_pallas=True, resolution=(512, 512),
            iterations=4, n_tiles=(1, 1),
        )
        scene, camera = load_scene(cfg, device="cuda")
        log(f"[5] medical scene written and loaded in "
            f"{time.perf_counter() - t0:.1f} s; albedo mode "
            f"{fast._albedo_mode(scene)}")

    # -- phase 3: kernel against plain version ------------------------------
    tables = tpk.dilated_tail_bricks(scene.medium.density.data)
    params = fast.tail_params(scene, cfg.settings)
    log(f"[3] dilated table {tuple(tables.tab.shape)} "
        f"({tables.tab.numel() * 4 / 1e6:.1f} MB)")
    errs, times = [], {}
    for n_paths in (128, 4096):
        err, ms, plain_ms = kernel_vs_plain(tables, params, n_paths)
        errs.append(err)
        times[n_paths] = (ms, plain_ms)

    # -- phase 4: white furnace and card-vs-CPU render ----------------------
    furnace_and_small_render()

    # -- phase 5: the slice -------------------------------------------------
    renderer = create_renderer(scene, camera, cfg)
    t0 = time.perf_counter()
    renderer.render()
    log(f"[5] warm-up render {time.perf_counter() - t0:.2f} s")
    torch.cuda.synchronize()
    tpk.KERNEL.launches = 0
    t0 = time.perf_counter()
    img = renderer.render()
    wall = time.perf_counter() - t0
    launches = tpk.KERNEL.launches
    n_rays = renderer.n_rays
    mean = float(img.mean())
    check(img.shape == (512, 512, 3) and np.isfinite(img).all(),
          "slice image not finite or wrong shape")
    check(0.05 < mean < 1.5, f"slice image mean {mean} implausible")
    check(n_rays > 0, "no rays traced")
    check(launches > 0, "the slice launched no tail kernel")
    log(f"[5] slice 512^2 x 4: {wall:.3f} s wall (incl. image copy), "
        f"{n_rays:.0f} rays, {n_rays / wall / 1e6:.4f} Mrays/s, "
        f"{launches} tail-kernel launches, image mean {mean:.5f}; card {card}")

    # -- phase 6: tracking kernel against plain version ---------------------
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        argv = [write_smoke_xml(tmp), "-k", "brickSK", "-i", "4", "-r", "400",
                "400", "--trials", "2", "-o", os.path.join(tmp, "brick_slice")]
        args = cli.build_parser().parse_args(argv)
        bcfg = cli.config_from_args(args)
        dev = cli.device_of(args.platform)
        bscene, bcamera = load_scene(bcfg, device=dev)
        log(f"[6] brickSK smoke scene written and loaded in "
            f"{time.perf_counter() - t0:.1f} s; albedo mode "
            f"{fast._albedo_mode(bscene)}")
        btables, bmajor = tk.build_dilated_bricks(bscene.medium.density.data)
        btables = btables.reshape(-1, tk.ROW)
        log(f"[6] dilated brick table {tuple(btables.shape)}")
        terrs, ttimes = [], {}
        for n_rows, n_steps in ((8, 8), (1250, 8), (8, 32), (1250, 32)):
            err, tms, tplain = track_vs_plain(btables, bmajor, n_rows, n_steps)
            terrs.append(err)
            ttimes[n_rows, n_steps] = (tms, tplain)

        # -- phase 7: brickSK white furnace and card-vs-CPU render ---------
        brick_furnace_and_small_render()

        # -- phase 8: the brickSK slice through the CLI --------------------
        torch.cuda.synchronize()
        tk.KERNEL.launches = 0
        t0 = time.perf_counter()
        result = cli.run_test(bcfg, dev)
        cli_wall = time.perf_counter() - t0
        track_launches = tk.KERNEL.launches
        check(track_launches > 0, "the brickSK slice launched no tracking kernel")
        saved = load_hdr(bcfg.output_name + ".hdr")
        check(saved.shape == (400, 400, 3) and np.isfinite(saved).all(),
              "the CLI's saved image is not finite or has the wrong shape")
        log(f"[8] cli.run_test brickSK 400^2 x 4, 2 trials: {cli_wall:.2f} s "
            f"in all, {track_launches} tracking-kernel launches; mean time "
            f"{result['mean_time']:.3f} s (image copy excluded), "
            f"{result['mrays_per_sec']:.4f} Mrays/s")

        torch.cuda.synchronize()
        tk.KERNEL.launches = 0
        t0 = time.perf_counter()
        bimg, bn_rays, rounds = make_kernel_fn(bcfg)(
            bscene, bcamera, bcfg.settings, (400, 400),
            torch.zeros(2, device=dev), (400, 400), bcfg.iterations,
            bcfg.seed, 0, with_stats=True,
        )
        bimg = bimg.cpu().numpy() / bcfg.iterations
        bwall = time.perf_counter() - t0
        blaunches = tk.KERNEL.launches
        bn_rays = float(bn_rays)
        bmean = float(bimg.mean())
    check(np.isfinite(bimg).all(), "brickSK slice image not finite")
    check(0.05 < bmean < 1.5, f"brickSK slice image mean {bmean} implausible")
    check(blaunches == rounds > 0, f"{blaunches} launches in {rounds} rounds")
    check(abs(bn_rays - result["n_rays"]) <= 0.01 * bn_rays,
          "the timed render and the CLI trials traced different ray counts")
    log(f"[8] brickSK slice 400^2 x 4: {bwall:.3f} s wall (incl. image copy), "
        f"{bn_rays:.0f} rays, {bn_rays / bwall / 1e6:.4f} Mrays/s, "
        f"{rounds} rounds, {blaunches} tracking-kernel launches, "
        f"{bwall / rounds * 1e3:.2f} ms per round, image mean {bmean:.5f}; "
        f"card {card}")

    ms, plain_ms = times[128]
    tms, tplain = ttimes[1250, 8]
    print(json.dumps({"kernels": [{
        "name": "tailpk", "route": "cuda",
        "source": "cudavolumerenderer_tpu_torch/csrc/tailpk.cu",
        "replaces": "cudavolumerenderer_tpu/ops/pallas/tailpk.py:152",
        "launches": launches, "max_abs_err": max(errs),
        "ms": ms, "plain_ms": plain_ms,
    }, {
        "name": "track", "route": "cuda",
        "source": "cudavolumerenderer_tpu_torch/csrc/tracking.cu",
        "replaces": "cudavolumerenderer_tpu/ops/pallas/tracking.py:123",
        "launches": track_launches, "max_abs_err": max(terrs),
        "ms": tms, "plain_ms": tplain,
    }]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
