"""The thesis's three scene classes and the kernels' counts per row, shared
by the measurement drivers of this package.

The JAX package's drivers (benchmarks/run_suite.py:52-71 and each
micro_* script) build the same three synthetic stand-ins in place, with
the reference workloads' shapes (the original volumes are LFS-stubbed):

  * bucky: blob_volume 32^3, the RAW transfer-function albedo, scale 40,
    rendered at 256^2 x 20;
  * smoke: smoke_volume 128x128x50, albedo 0.9 d, scale 800 (thesis
    Table 6.2's smoke), at 400^2 x 4;
  * medical: medical_volume 256^3 with 40 blobs, albedo (d, 0.5, 1 - d)
    (affine in density, so fastSK's tail kernel may run), scale 100, at
    512^2 x 4.

micro_ablate's medical stand-in differs (benchmarks/micro_ablate.py:75):
its 40 blobs are the raw blob field, without medical_volume's
min-max normalization and smoothstep, so far less of the grid is empty;
it is `medical_blobs` here, at the medical class's albedo, scale and size.

`CLASSES` holds those published sizes; the drivers read them at call time,
so a test may shrink them.  procedural keeps the last few blob fields, so a
process makes each 256^3 grid once.

`RowCounts` sets the kernels' counts to 0 when a row starts and reads them
when it ends: every body kernel's launches, the host's reads, and the
eager evaluations (the plain versions', which run on the CPU and, on the
card, only when a caller asks for them); beside them, `kernels`, the counts
that the row must find above 0 on the card.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from ..config import Config
from ..ops.camera import make_camera
from ..scene import procedural
from ..scene.raw_builder import albedo_from_density
from ..scene.types import make_medium, make_scene

#: name -> (grid (x, y, z), resolution, iterations) at the published sizes
CLASSES: Dict[str, Tuple[Tuple[int, int, int], int, int]] = {
    "bucky": ((32, 32, 32), 256, 20),
    "smoke": ((128, 128, 50), 400, 4),
    "medical": ((256, 256, 256), 512, 4),
    "medical_blobs": ((256, 256, 256), 512, 4),
}
#: the body kernel each scheduler of create_renderer launches on the card
#: (RowCounts' names; fastQ's kernel is not counted here)
SCHEDULER_KERNELS: Dict[str, Tuple[str, ...]] = {
    "fastSK": ("fastbody",), "brickSK": ("brickbody",), "fastQ": (),
    **dict.fromkeys(("naiveSK", "naiveMK", "regenerationSK", "streamingSK",
                     "streamingMK", "sortingSK"), ("familybody",)),
}


def arrays(name: str, grid: Tuple[int, int, int]):
    """(density (Z, Y, X), albedo, scale, max_density) of class `name` on
    `grid`, as the JAX drivers make them (numpy)."""
    if name == "bucky":
        d = procedural.blob_volume(grid)
        out = d, albedo_from_density(d), 40.0, 1.0
    elif name == "smoke":
        d = procedural.smoke_volume(grid)
        out = d, np.stack([d, d, d], axis=-1) * 0.9, 800.0, float(d.max())
    elif name in ("medical", "medical_blobs"):
        make = (procedural.medical_volume if name == "medical"
                else procedural.blob_volume)
        d = make(grid, n_blobs=40)
        out = (d, np.stack([d, 0.5 * np.ones_like(d), 1.0 - d], axis=-1),
               100.0, 1.0)
    else:
        raise ValueError(f"no scene class {name!r}")
    return out


def scene(name: str, device, grid=None):
    """The class's Scene on `device` (its published grid unless `grid`)."""
    d, albedo, scale, max_density = arrays(name, tuple(grid or CLASSES[name][0]))
    return make_scene(make_medium(d, albedo, scale=scale,
                                  max_density=max_density, device=device))


def size(name: str) -> Tuple[int, int]:
    """(resolution, iterations) of the class."""
    return CLASSES[name][1], CLASSES[name][2]


def camera(res: int, device):
    return make_camera(res, res, device=device)


def gated_bits(kw: dict, settings) -> dict:
    """kw with table_bits through Config.effective_table_bits (the CLI's
    `--table-bits N --allow-quantized` gate)."""
    kw = dict(kw)
    kw["table_bits"] = Config(table_bits=kw.get("table_bits", 32),
                              allow_quantized=True,
                              settings=settings).effective_table_bits
    return kw


def _kernels():
    from ..ops import brickbody, familybody, fastbody, taildrain, tailpk, tracking

    return brickbody.KERNEL, familybody.KERNEL, fastbody.KERNEL, \
        taildrain.KERNEL, tailpk.KERNEL, tracking.KERNEL


class RowCounts:
    """A context around one row, which must launch `kernels` (names of its
    counts: "fastbody", "familybody", "brickbody", "taildrain") on the
    card: the counts set to 0 on entry; on exit `counts` holds `kernels`,
    each body kernel's launches (fastbody and familybody drains included),
    the host's reads of their control words, the tail
    and tracking kernels' launches (made only by the eager loops), and
    `eager`, the plain versions' evaluations (fastSK's eager body, the
    family's and brickSK's plain entry points, the tail stage's eager
    rounds), and `family_longest_lane`, the bounces of the longest lane of
    the family's last drain (naiveSK's trace; None without one)."""

    def __init__(self, *kernels: str):
        self.kernels = list(kernels)

    def __enter__(self):
        brick, fam, fb, td, tpk, trk = _kernels()
        for k in (brick, fam, fb, td):
            k.reset()
        fam.last_drain = None
        tpk.launches = trk.launches = 0
        return self

    def __exit__(self, *exc):
        brick, fam, fb, td, tpk, trk = _kernels()
        self.counts = {
            "kernels": self.kernels,
            "fastbody": fb.launches + fb.drain_launches,
            "familybody": sum(fam.by_op.values()) + fam.drain_launches,
            "brickbody": sum(brick.by_op.values()),
            "taildrain": td.drain_launches,
            "tailpk": tpk.launches, "tracking": trk.launches,
            "reads": fb.reads + fam.reads + brick.reads + td.reads,
            "eager": (fb.plain_evals + sum(fam.plain_evals.values())
                      + sum(brick.plain_evals.values()) + td.plain_rounds),
            "family_longest_lane": (fam.last_drain["L"] if fam.last_drain
                                    else None),
        }
        return False
