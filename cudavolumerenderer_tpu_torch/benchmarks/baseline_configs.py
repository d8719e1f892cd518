"""BASELINE forward configs 1-4, end to end through the real file loaders
and the CLI's run_test protocol (trials, discard-first mean, Mrays/s;
Main.cpp:46-121 semantics).

Port of benchmarks/baseline_configs.py.  Each config writes its scene
FILE first (the reference assets are LFS-stubbed), then loads it the way
a user would:

  1. bucky: 32^3 raw uchar file -> RawSceneBuilder semantics, 256^2 x 20.
  2. medical: 256^3 MHD file (smoothstep CT convention) at 512^2 x 4, the
     manix/artifix class.
  3. hetvol: smoke 128x128x50, albedo 0.9 d, written as a real .vdb
     archive and read by the native reader, 1024^2 x 4.
  4. MitsubaXml: density + albedo .vol files and a scene XML, 400^2 in
     10x10 tiles (one fastSK cascade per pass), 50 iterations.

All four run fastSK two-level.

    python -m cudavolumerenderer_tpu_torch.benchmarks.baseline_configs \\
        [--platform cuda|cpu] [--quick] [--only SUBSTR ...] [--trials N] \\
        [--out path] [--workdir dir]

`--platform cuda` (the default) renders on the card and raises without
one.  `--quick` renders 64^2 (CPU smoke test).  The scene files and
images go to --workdir (default: baseline_configs under the temporary
directory); only the selected configs write theirs.  The JSON has the
JAX script's keys plus n_rays and the mean time with the image copy;
a file is written only when --out names it.  `--champion` applies the
JAX script's tuned knobs (`champion`): q4 packed density tables through
the allow_quantized gate and min_width 64 on every row, and on the
medical row max_bricks 512 and cascade factor 1.25; its rows are labelled
"q4-reduced".
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

import numpy as np

from .. import cli
from ..config import Config, Kernel
from ..scene import procedural, vdb
from ..scene.types import RenderSettings
from ..scene.vol import write_vol

MITSUBA_XML = """<scene version="0.5.0">
  <medium type="heterogeneous" id="smoke">
    <volume name="density" type="gridvolume">
      <string name="filename" value="density.vol"/>
    </volume>
    <volume name="albedo" type="gridvolume">
      <string name="filename" value="albedo.vol"/>
    </volume>
    <float name="scale" value="100"/>
  </medium>
  <sensor type="perspective">
    <!-- frame the unit box from z=100 (it subtends ~0.57 deg) -->
    <float name="fov" value="0.7"/>
    <film type="hdrfilm">
      <integer name="width" value="400"/>
      <integer name="height" value="400"/>
    </film>
  </sensor>
</scene>
"""


def write_bucky(tmp: str) -> str:
    path = os.path.join(tmp, "bucky_synth.raw")
    procedural.write_raw_uchar(path, procedural.blob_volume((32, 32, 32)))
    return path


def write_medical_mhd(tmp: str) -> str:
    """256^3 CT-style u16 counts; the loader min-max normalizes and
    applies smoothstep(0.2, 0.6), the manix/artifix pipeline convention
    (scripts/convert-mhd/mhd_to_vdb.py)."""
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


def smoke_and_albedo():
    """Configs 3-4's medium: smoke 128x128x50 and an RGB albedo 0.9 d."""
    d = procedural.smoke_volume((128, 128, 50)).astype(np.float32)
    return d, (np.stack([d, d, d], axis=-1) * 0.9).astype(np.float32)


def write_hetvol_vdb(tmp: str) -> str:
    path = os.path.join(tmp, "hetvol_synth.vdb")
    vdb.write_vdb(path, *smoke_and_albedo())
    return path


def write_mitsuba_xml(tmp: str) -> str:
    d, alb = smoke_and_albedo()
    box = ((-0.5, -0.5, -0.5), (0.5, 0.5, 0.5))
    write_vol(os.path.join(tmp, "density.vol"), d, *box)
    write_vol(os.path.join(tmp, "albedo.vol"), alb, *box)
    path = os.path.join(tmp, "hetvol_scene.xml")
    with open(path, "w") as f:
        f.write(MITSUBA_XML)
    return path


def rows(quick: bool):
    """(name, scene writer, kernel, res, iterations, tiles, reference row)."""
    return [
        ("1_bucky_raw_256_20it", write_bucky, Kernel.FAST_SK,
         64 if quick else 256, 4 if quick else 20, (1, 1),
         "thesis T6.3 regenSK 10.96 Mrays/s"),
        ("2_medical_mhd_512", write_medical_mhd, Kernel.FAST_SK,
         64 if quick else 512, 4, (1, 1),
         "thesis T4.3 manix regenSK 11.4-14.8 Mrays/s"),
        ("3_hetvol_vdb_1024", write_hetvol_vdb, Kernel.FAST_SK,
         64 if quick else 1024, 4, (1, 1),
         "thesis T6.2 streamingSK 17.41 Mrays/s (400^2)"),
        ("4_mitsubaxml_10x10_50it", write_mitsuba_xml, Kernel.FAST_SK,
         64 if quick else 400, 5 if quick else 50, (10, 10),
         "config 4: tiled progressive, 10x10 tiles"),
    ]


def champion(name: str) -> dict:
    """The JAX script's --champion Config fields for config `name`."""
    champ = dict(table_bits=4, allow_quantized=True, min_width=64)
    if name.startswith("2_"):
        champ.update(max_bricks=512, cascade_factor=1.25)
    return champ


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m cudavolumerenderer_tpu_torch.benchmarks.baseline_configs")
    ap.add_argument("--platform", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--trials", type=int, default=3)
    ap.add_argument("--quick", action="store_true",
                    help="small resolutions (CPU smoke test)")
    ap.add_argument("--out", default=None, help="write the JSON here")
    ap.add_argument("--workdir", default=None,
                    help="scene files and images (default: under the "
                    "temporary directory)")
    ap.add_argument("--only", nargs="*", default=None,
                    help="run only configs whose name contains any substring")
    ap.add_argument("--champion", action="store_true",
                    help="the tuned per-class knobs (q4 packed tables, "
                    "min_width 64; medical: 512 bricks, cascade 1.25); "
                    "reduced-precision rows, labelled so in the JSON")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    device = cli.device_of(args.platform)
    tmp = args.workdir or os.path.join(tempfile.gettempdir(), "baseline_configs")
    os.makedirs(tmp, exist_ok=True)

    selected = [r for r in rows(args.quick)
                if not args.only or any(s in r[0] for s in args.only)]
    results = {}
    for name, write, kernel, res, iters, tiles, ref in selected:
        path = write(tmp)
        config = Config(
            scene_file=path, kernel=kernel, iterations=iters,
            resolution=(res, res), n_tiles=tiles, trials=args.trials,
            output_name=os.path.join(tmp, name), two_level=True,
            settings=RenderSettings.from_flags(True),
            **(champion(name) if args.champion else {}),
        )
        print(f"=== {name} ({path})", flush=True)
        r = cli.run_test(config, device)
        results[name] = {
            "mrays_per_sec": round(r["mrays_per_sec"], 3),
            "mean_time_s": round(r["mean_time"], 3),
            "mean_time_with_copy_s": round(r["mean_time_with_copy"], 3),
            "n_rays": r["n_rays"],
            "resolution": res, "iterations": iters,
            "tiles": list(tiles), "reference": ref,
            # the JAX script's scene-version tags: config 4's XML frames
            # the box at fov 0.7 (round 4), the others are round 3's
            "scene_version": "r4-fov0.7" if name.startswith("4_") else "r3",
            "precision": "q4-reduced" if args.champion else "f32",
        }
        if args.out:
            with open(args.out, "w") as f:
                json.dump(results, f, indent=2)
    print(json.dumps(results, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
