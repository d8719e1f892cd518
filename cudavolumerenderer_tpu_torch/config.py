"""Runtime configuration (reference: Config.h:35-248,
ConfigParser.cpp:10-165).

Port of cudavolumerenderer_tpu/config.py with the same fields and
defaults, so a configuration means the same render in both packages.
"""

from __future__ import annotations

import dataclasses
import enum
import math
import os
from typing import Optional, Tuple

from .scene.types import RenderSettings


class Kernel(enum.Enum):
    """Scheduling strategies (reference: Config.h:87-95 Kernel enum);
    every value renders through models/renderer.make_kernel_fn."""

    NAIVE_SK = "naiveSK"
    NAIVE_MK = "naiveMK"
    REGENERATION_SK = "regenerationSK"
    STREAMING_MK = "streamingMK"
    STREAMING_SK = "streamingSK"
    SORTING_SK = "sortingSK"
    FAST_SK = "fastSK"
    BRICK_SK = "brickSK"
    FAST_Q = "fastQ"

    @classmethod
    def from_name(cls, name: str) -> "Kernel":
        for k in cls:
            if k.value.lower() == name.lower():
                return k
        raise ValueError(
            f"unknown kernel {name!r}; choose from "
            f"{[k.value for k in cls]}"
        )


class Algorithm(enum.Enum):
    """Only one algorithm exists (reference: Config.h:82-85)."""

    CUDA_VOL_PATH = "cudaVolPath"


class SceneType(enum.Enum):
    AUTO = "Auto"
    MITSUBA_XML = "MitsubaXml"
    VDB = "Vdb"
    RAW = "Raw"
    MHD = "Mhd"
    NPZ = "Npz"

    @classmethod
    def detect(cls, scene_path: str) -> "SceneType":
        """Extension-based auto-detection (reference: ConfigParser.cpp:79-97)."""
        ext = os.path.splitext(scene_path)[1].lower()
        if ext == ".xml":
            return cls.MITSUBA_XML
        if ext == ".vdb":
            return cls.VDB
        if ext in (".mhd", ".mha"):
            return cls.MHD
        if ext == ".npz":
            return cls.NPZ
        return cls.RAW


@dataclasses.dataclass
class TilingConfig:
    """Image tiling (reference: Config.h:61-78): tile_dim = ceil(res / n)."""

    resolution: Tuple[int, int] = (1024, 1024)
    n_tiles: Tuple[int, int] = (1, 1)

    @property
    def tile_dim(self) -> Tuple[int, int]:
        return (
            math.ceil(self.resolution[0] / self.n_tiles[0]),
            math.ceil(self.resolution[1] / self.n_tiles[1]),
        )


@dataclasses.dataclass
class Config:
    """Full run configuration; field meanings as in the JAX package's
    Config (cudavolumerenderer_tpu/config.py)."""

    scene_file: Optional[str] = None
    scene_type: SceneType = SceneType.AUTO
    algorithm: Algorithm = Algorithm.CUDA_VOL_PATH
    kernel: Kernel = Kernel.FAST_SK
    iterations: int = 20
    resolution: Tuple[int, int] = (1024, 1024)
    n_tiles: Tuple[int, int] = (1, 1)
    #: batch-mode trials (cli.run_test); the first is discarded when > 1
    trials: int = 1
    #: progressive mode with frame dumps (cli.run_interactive)
    interactive: bool = False
    #: output path stem for .hdr/.png; None = to_string()
    output_name: Optional[str] = None
    seed: int = 1234
    #: wavefront pool size for the queue-fed schedulers; None = sized
    #: from the work and device memory (utils/occupancy.py)
    n_lanes: Optional[int] = None
    #: regenerationSK refill granularity (reference:
    #: REGENERATION_SYNCHRONIZATION_LEVEL, Defines.h:40-42): 0 = per lane,
    #: 1 = per 8-lane group, 2 = per 1024-lane row
    regeneration_level: int = 0
    #: samples per launch of naiveSK/naiveMK (bounds the lanes they hold)
    spp_per_launch: int = 4
    #: fastSK two-level (sparse-leap) tracking
    two_level: bool = False
    lanes_per_pixel: int = 1
    #: fastSK deferred boundary events: a batched GGX flush every N evaluations
    defer_ggx: int = 0
    #: fastSK (8,8,128) brick-major table layout
    brick_major: bool = False
    #: fastSK cascade pool shrink factor (may be fractional)
    cascade_factor: float = 2
    #: fastSK single-level tail pools and speculative tail steps
    tail_single_level: bool = False
    tail_spec: int = 1
    #: pool width below which the spec/single-level tail modes engage
    spec_width: Optional[int] = None
    #: cascade bottom pool width; None = 4096 (widths quantize to
    #: multiples of 256, so values below 256 equal 256)
    min_width: Optional[int] = None
    #: finer tail-pool brick granularity
    tail_bricks: int = 0
    #: fastSK two-level probe-table size cap (None = fast.py's default)
    max_bricks: Optional[int] = None
    #: packed 8/4-bit density tables
    table_bits: int = 32
    allow_quantized: bool = False
    #: fastSK persistent tail kernel (ops/tailpk.py, csrc/tailpk.cu):
    #: tracking + scatter + RR for the last tail_pk_width pending lanes;
    #: requires const/affine albedo
    tail_pallas: bool = False
    tail_pk_width: int = 128
    tail_pk_steps: int = 16
    settings: RenderSettings = dataclasses.field(
        default_factory=lambda: RenderSettings.from_flags(True)
    )

    @property
    def effective_table_bits(self) -> int:
        """The table precision the render actually runs at: quantized
        tables engage only when mitsuba_comparable is off or
        allow_quantized is set."""
        if self.settings.mitsuba_comparable and not self.allow_quantized:
            return 32
        return self.table_bits

    @property
    def tiling(self) -> TilingConfig:
        return TilingConfig(resolution=self.resolution, n_tiles=self.n_tiles)

    def to_string(self) -> str:
        """Default output name (reference: Config.h:237-248)."""
        return (
            f"algorithm_{self.algorithm.value}_kernel_{self.kernel.value}"
            f"_iter_{self.iterations}"
        )
