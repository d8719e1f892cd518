#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (cudavolumerenderer_tpu_torch) on
one CUDA card.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; nothing falls back to the
CPU or to a plain version on a CUDA tensor):

1. identify the card (nvidia-smi name and power limit); refuse to run
   without CUDA;
2. build the three kernel libraries, csrc/tailpk.cu, csrc/tracking.cu
   and csrc/pgather.cu, with one nvcc each, started together (into the
   package's ignored _build/ directory); print the build times and
   ptxas registers and spills;
3. the kernel against its plain torch version on the card, on the
   medical 256^3 dilated-brick table with R = 128 and R = 4096 paths at
   K = 16 steps: integer outputs equal on >= 99.9% of paths, floats
   allclose (rtol 1e-5, atol 1e-6) on those; the kernel's device time
   per call from replays of a CUDA graph of 16 calls, the plain version's
   with CUDA events around eager calls; the bound from the bytes the call
   moves (state rows, and the table words its taps read, counted from
   the plain version's taps) and a lower count of its operations;
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
   >= 99.9% of lanes, t allclose (rtol 1e-5, atol 1e-6) on those; timed
   and bounded as in phase 3, and at R = 1,250, K = 8 also timed with cold
   inputs;
7. white furnace through brickSK on the card (every pixel == spp), and a
   small brickSK render on the card against the same render on the CPU;
8. the brickSK slice (the smoke class of benchmarks/micro_smoke_brick.py:
   smoke 128x128x50, albedo 0.9 d, scale 800, written as Mitsuba XML +
   .vol files like BASELINE config 4) through the CLI's batch mode:
   -k brickSK -i 4 -r 400 400, two trials (the first discarded); the
   tracking kernel's launch count must rise; then one timed render
   through brick.render_tile (the function make_kernel_fn returns),
   image copied to the host, with its round count;
9. each of the five gather kernels (csrc/pgather.cu) against its plain
   torch version at the gather benchmark's published shapes (67 MB
   table, N = 262,144, S = 16): bit-equal outputs; the kernel, its plain
   version and the one torch call that computes the same function (its
   yardstick, library_ms) each timed per call by CUDA events around
   replays of a CUDA graph of 16 back-to-back calls on the same inputs,
   so the wrapper's host time stays out (kernel and yardstick twice, in
   turns); for taa0, stream and vmem also cold, a graph of 16 calls on 16
   fresh index sets; the bound from the bytes the gather moves (indices,
   the distinct values read, outputs) and the floor at 32-byte sectors;
10. the gather benchmark's entry point (benchmarks/micro_pgather.main) at
   its defaults, every variant at 67 MB, then at --table-mb 4300 on
   xla_big, xla_sorted, xla_packed, xla_packed8f and pallas_binned with 3
   reps; each variant's M rows/s printed, the JSON checked, and every
   gather kernel's launch count must rise.

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
HBM_BYTES_PER_MS = 3.35e9  # H100 SXM device memory, 3.35 TB/s
PEAK_OPS_PER_MS = 67e9  # H100 SXM float32 outside the tensor cores, 67 T/s
GRAPH_CALLS = 16  # calls per timed CUDA graph
COLD = ("taa0", "stream", "vmem")  # gathers also timed on fresh indices
GATHER_N, GATHER_S = 262144, 16  # the gather benchmark's published N and S
GATHER_BIG = ("xla_big", "xla_sorted", "xla_packed", "xla_packed8f",
              "pallas_binned")  # the variants run at 4.3 GB
# each gather kernel's Pallas body (file:line)
GATHER_REPLACES = {
    "taa1": "benchmarks/micro_pgather.py:284",
    "taa0": "benchmarks/micro_pgather.py:310",
    "vmem": "benchmarks/micro_pgather.py:334",
    "stream": "benchmarks/micro_pgather.py:354",
    "binned": "benchmarks/micro_pgather.py:390",
}
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


def graph_ms(calls, replays: int = 10) -> float:
    """Milliseconds per call, CUDA events around `replays` replays of a
    CUDA graph of the given calls back to back (no host time per call)."""
    import torch

    from cudavolumerenderer_tpu_torch.benchmarks.micro_pgather import GraphRun

    graphed = GraphRun(lambda: [fn() for fn in calls], ())
    graphed.run()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(replays):
        graphed.run()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / (replays * len(calls))


def bound_ms(n_bytes: int, n_ops: int = 0):
    """(least milliseconds, "bytes" or "operations"): the larger of the
    bytes over the memory rate and the operations over the peak rate."""
    by_bytes, by_ops = n_bytes / HBM_BYTES_PER_MS, n_ops / PEAK_OPS_PER_MS
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def tap_bound(taps, bytes_of_words, step_ops: int):
    """(bound ms, bound_by, bytes, distinct table words, taps) of one call
    of a render kernel whose plain version reported `taps`."""
    import torch

    pos = torch.cat(taps)
    words = int(pos.unique().numel())
    n_bytes = bytes_of_words(words)
    return (*bound_ms(n_bytes, step_ops * pos.numel()), n_bytes, words,
            pos.numel())


def gather_vs_plain(table, name: str, card: str) -> dict:
    """Phase 9 for one gather kernel: its error, times and bound."""
    import torch

    from cudavolumerenderer_tpu_torch.benchmarks import micro_pgather as mpg
    from cudavolumerenderer_tpu_torch.ops import pgather as pg

    args = mpg.kernel_args(name, table, GATHER_N, GATHER_S)
    run, plain = pg.WRAPPERS[name]
    lib = pg.YARDSTICKS[name]
    before = pg.KERNELS[name].launches
    got = run(*args)
    torch.cuda.synchronize()
    check(pg.KERNELS[name].launches == before + 1, f"{name} did not launch")
    want = plain(*args)
    check(torch.equal(got, want), f"gather kernel {name} is not bit-equal "
          "to its plain version")
    i64 = args[1].long()
    check(torch.equal(lib(args[0], i64), want),
          f"{name}'s yardstick differs from its plain version")
    err = float((got - want).abs().max())

    def kernel():
        return run(*args)

    def library():
        return lib(args[0], i64)

    # in turns: kernel, yardstick, plain, yardstick, kernel
    ms_a = graph_ms([kernel] * GRAPH_CALLS)
    lib_a = graph_ms([library] * GRAPH_CALLS)
    plain_ms = graph_ms([lambda: plain(*args)] * GRAPH_CALLS)
    lib_b = graph_ms([library] * GRAPH_CALLS)
    ms_b = graph_ms([kernel] * GRAPH_CALLS)
    n = args[1].numel()
    values, sectors = pg.touched(name, args[1])
    bound, bound_by = bound_ms(pg.gather_bytes(n, values))
    sector_ms = pg.gather_bytes(n, sectors, 32) / HBM_BYTES_PER_MS
    res = {"max_abs_err": err, "ms": (ms_a + ms_b) / 2, "plain_ms": plain_ms,
           "library_ms": (lib_a + lib_b) / 2, "bound_ms": bound,
           "bound_by": bound_by}
    log(f"[9] {name}: idx {tuple(args[1].shape)} into tab "
        f"{tuple(args[0].shape)}: bit-equal, max |err| {err:.3g}; per call "
        f"kernel {ms_a * 1e3:.2f} / {ms_b * 1e3:.2f} us, yardstick "
        f"{lib_a * 1e3:.2f} / {lib_b * 1e3:.2f} us, plain torch "
        f"{plain_ms * 1e3:.2f} us; bound {bound * 1e3:.3f} us by {bound_by} "
        f"({pg.gather_bytes(n, values)} B, {values} distinct values), the "
        f"kernel at {bound / res['ms']:.1%} of it; 32-byte-sector floor "
        f"{sector_ms * 1e3:.3f} us ({sectors} sectors); card {card}")
    if name in COLD:
        sets = [mpg.kernel_args(name, table, GATHER_N, GATHER_S, rep)
                for rep in range(GRAPH_CALLS)]
        wide = [a[1].long() for a in sets]
        cold_k = graph_ms([lambda a=a: run(*a) for a in sets])
        cold_l = graph_ms([lambda a=a, w=w: lib(a[0], w)
                           for a, w in zip(sets, wide)])
        cold_k2 = graph_ms([lambda a=a: run(*a) for a in sets])
        log(f"[9] {name} cold (16 fresh index sets per graph): kernel "
            f"{cold_k * 1e3:.2f} / {cold_k2 * 1e3:.2f} us, yardstick "
            f"{cold_l * 1e3:.2f} us per call; card {card}")
    return res


def gather_benchmark(tmp: str, card: str):
    """Phase 10: the gather benchmark's entry point at 67 MB (every
    variant) and 4.3 GB (the named subset); returns the gather kernels'
    launch counts over both runs."""
    import torch

    from cudavolumerenderer_tpu_torch.benchmarks import micro_pgather as mpg
    from cudavolumerenderer_tpu_torch.ops import pgather as pg

    runs = (("67", []), ("4300", ["--table-mb", "4300", "--only",
                                  ",".join(GATHER_BIG), "--reps", "3"]))
    torch.cuda.synchronize()
    for kern in pg.KERNELS.values():
        kern.launches = 0
    rates = {}
    for mb, argv in runs:
        path = os.path.join(tmp, f"pgather_{mb}.json")
        t0 = time.perf_counter()
        ret = mpg.main([*argv, "--json-out", path])
        log(f"[10] micro_pgather at {mb} MB: {time.perf_counter() - t0:.1f} s")
        with open(path) as f:
            saved = json.load(f)
        check(saved == ret, "the benchmark's JSON differs from its result")
        check(list(saved) == ["V", "N", "S", "inner", "platform", "results"],
              f"JSON keys {list(saved)}")
        check(saved["V"] == mpg.table_rows(float(mb), 16)
              and saved["N"] == GATHER_N and saved["S"] == GATHER_S
              and saved["inner"] == 16 and saved["platform"] == "cuda",
              f"JSON header {saved}")
        for name, res in saved["results"].items():
            check(sorted(res) == ["mrows_s", "ms_per_gather"]
                  and all(np.isfinite(v) and v > 0 for v in res.values()),
                  f"{mb} MB {name}: {res}")
            rates.setdefault(name, {})[mb] = res
    names = set(rates)
    want_67 = {"xla_small_1mb", "xla_small_4mb", "xla_wide_1mb",
               "xla_wide_8mb", "xla_wide_16mb"} | {
        v for v in mpg.VARIANTS if v not in ("xla_small", "xla_wide")}
    check(names == want_67, f"variants run at 67 MB: {sorted(names)}")
    check({n for n in names if "4300" in rates[n]} == set(GATHER_BIG),
          "variants run at 4.3 GB")
    launches = {k: kern.launches for k, kern in pg.KERNELS.items()}
    check(all(n > 0 for n in launches.values()),
          f"a gather kernel never launched in the benchmark: {launches}")
    log(f"[10] gather kernel launches (graph replays x 16 + warm-ups + "
        f"checks): {launches}")
    log(f"[10] per gather, card {card}:")
    order = {v: i for i, v in enumerate(mpg.VARIANTS)}
    for name in sorted(rates, key=lambda n: order.get(n, order.get(
            n.rsplit("_", 1)[0]))):
        cells = "  ".join(
            f"{mb} MB {r['ms_per_gather'] * 1e3:9.2f} us "
            f"{r['mrows_s']:10.1f} M rows/s" for mb, r in rates[name].items())
        log(f"[10]   {name:16s} {cells}")
    return launches


def kernel_vs_plain(tables, params, n_paths: int, card: str):
    """Phase 3 at one width: returns (max_abs_err, kernel ms, plain ms,
    bound ms, bound_by)."""
    import torch

    from cudavolumerenderer_tpu_torch.ops import tailpk as tpk

    inputs = tpk.random_tail_state(tables, params, n_paths, seed=n_paths)
    args = (tables.tab, *inputs[:1], params, *inputs[1:])
    got = tpk.run_tail_steps(*args, n_steps=N_STEPS)
    torch.cuda.synchronize()
    taps = []
    want = tpk.tail_steps(*args, n_steps=N_STEPS, taps=taps)
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
    ms = graph_ms([lambda: tpk.run_tail_steps(*args, n_steps=N_STEPS)]
                  * GRAPH_CALLS)
    plain_ms = cuda_ms(lambda: tpk.tail_steps(*args, n_steps=N_STEPS), 10, 2)
    bound, bound_by, n_bytes, words, n_taps = tap_bound(
        taps, lambda w: tpk.tail_bytes(n_paths, w), tpk.STEP_OPS)
    log(f"[3] R={n_paths}: kernel {ms * 1e3:.2f} us of device time per "
        f"{N_STEPS}-step call (graph of {GRAPH_CALLS}), plain torch "
        f"{plain_ms:.4f} ms (eager, host-bound); bound {bound * 1e3:.4f} us "
        f"by {bound_by} ({n_bytes} B, {words} distinct table words of "
        f"{n_taps} taps), the kernel at {bound / ms:.2%} of it; max "
        f"|err| {err:.3g}; card {card}")
    return err, ms, plain_ms, bound, bound_by


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


def track_vs_plain(tables, major, n_rows: int, n_steps: int, card: str):
    """Phase 6 at one shape: returns (max_abs_err, kernel ms, plain ms,
    bound ms, bound_by)."""
    import torch

    from cudavolumerenderer_tpu_torch.ops import tracking as tk

    inputs = tk.random_track_state(
        major, n_rows, seed=n_rows + n_steps, scale=800.0,
        vox_per_unit=(127.0, 127.0, 49.0),
    )
    args = (tables, *inputs)
    got = tk.run_track_steps(*args, n_steps=n_steps)
    torch.cuda.synchronize()
    taps = []
    want = tk.track_steps(*args, n_steps=n_steps, taps=taps)
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
    ms = graph_ms([lambda: tk.run_track_steps(*args, n_steps=n_steps)]
                  * GRAPH_CALLS)
    plain_ms = cuda_ms(lambda: tk.track_steps(*args, n_steps=n_steps), 10, 2)
    bound, bound_by, n_bytes, words, n_taps = tap_bound(
        taps, lambda w: tk.track_bytes(n_rows, w), tk.STEP_OPS)
    log(f"[6] R={n_rows} K={n_steps}: kernel {ms * 1e3:.2f} us of device "
        f"time per call (graph of {GRAPH_CALLS}), plain torch "
        f"{plain_ms:.4f} ms (eager, host-bound); bound {bound * 1e3:.3f} us "
        f"by {bound_by} ({n_bytes} B, {words} distinct table words of "
        f"{n_taps} taps), the kernel at {bound / ms:.1%} of it; max "
        f"|err| {err:.3g}; card {card}")
    return err, ms, plain_ms, bound, bound_by


def track_cold(tables, major, card: str) -> None:
    """Phase 6 at the slice's shape (R = 1,250, K = 8): the kernel's device
    time with its inputs cold (a graph of 16 calls on 16 input sets,
    16 x 15.4 MB), beside the graph of 16 calls on one input set, whose
    inputs stay in L2."""
    from cudavolumerenderer_tpu_torch.ops import tracking as tk

    def inputs(seed):
        return (tables, *tk.random_track_state(
            major, 1250, seed=seed, scale=800.0,
            vox_per_unit=(127.0, 127.0, 49.0)))

    sets = [inputs(1258 + k) for k in range(GRAPH_CALLS)]
    cold = graph_ms([lambda a=a: tk.run_track_steps(*a, n_steps=8)
                     for a in sets])
    log(f"[6] R=1250 K=8: kernel {cold * 1e3:.2f} us per call with cold "
        f"inputs (16 input sets per graph); card {card}")


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
    from cudavolumerenderer_tpu_torch.benchmarks import micro_pgather as mpg
    from cudavolumerenderer_tpu_torch.ops import pgather as pg
    from cudavolumerenderer_tpu_torch.ops import tailpk as tpk
    from cudavolumerenderer_tpu_torch.ops import tracking as tk
    from cudavolumerenderer_tpu_torch.scene.loader import load_scene
    from cudavolumerenderer_tpu_torch.utils.image import load_hdr

    # -- phase 2: build the three libraries, one nvcc each, started together
    libraries = (tpk.KERNEL, tk.KERNEL, pg.LIBRARY)
    with ThreadPoolExecutor(len(libraries)) as pool:
        builds = [pool.submit(k.library) for k in libraries]
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
        err, *timed = kernel_vs_plain(tables, params, n_paths, card)
        errs.append(err)
        times[n_paths] = timed

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
            err, *timed = track_vs_plain(btables, bmajor, n_rows, n_steps,
                                         card)
            terrs.append(err)
            ttimes[n_rows, n_steps] = timed

        track_cold(btables, bmajor, card)

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

    # -- phase 9: the gather kernels against their plain versions ----------
    t0 = time.perf_counter()
    gtable = torch.from_numpy(
        mpg.make_table(mpg.table_rows(67.0, GATHER_S))).to("cuda")
    log(f"[9] gather table {tuple(gtable.shape)} "
        f"({gtable.numel() * 4 / 2**20:.0f} MB) made in "
        f"{time.perf_counter() - t0:.1f} s")
    gathers = {name: gather_vs_plain(gtable, name, card) for name in pg.NAMES}
    del gtable

    # -- phase 10: the gather benchmark's entry point -----------------------
    with tempfile.TemporaryDirectory() as tmp:
        glaunches = gather_benchmark(tmp, card)

    def timed(ms, plain_ms, bound, bound_by):
        return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                "bound_by": bound_by, "library_ms": None}

    gather_lines = [{
        "name": f"pgather_{name}", "route": "cuda",
        "source": "cudavolumerenderer_tpu_torch/csrc/pgather.cu",
        "replaces": GATHER_REPLACES[name], "launches": glaunches[name],
        **gathers[name],
    } for name in pg.NAMES]
    print(json.dumps({"kernels": [{
        "name": "tailpk", "route": "cuda",
        "source": "cudavolumerenderer_tpu_torch/csrc/tailpk.cu",
        "replaces": "cudavolumerenderer_tpu/ops/pallas/tailpk.py:152",
        "launches": launches, "max_abs_err": max(errs), **timed(*times[128]),
    }, {
        "name": "track", "route": "cuda",
        "source": "cudavolumerenderer_tpu_torch/csrc/tracking.cu",
        "replaces": "cudavolumerenderer_tpu/ops/pallas/tracking.py:123",
        "launches": track_launches, "max_abs_err": max(terrs),
        **timed(*ttimes[1250, 8]),
    }, *gather_lines]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
