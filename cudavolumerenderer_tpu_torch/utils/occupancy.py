"""Pool sizing and device-memory guard.

Port of cudavolumerenderer_tpu/utils/occupancy.py (reference:
Occupancy.cuh:24-70, Config.h:119-159).  The budget is the card's total
memory from `torch.cuda.mem_get_info`; on the CPU it is the host's
physical memory.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import torch

#: never spend more than this fraction of the budget on per-lane
#: wavefront state (the rest is grids and tables)
_LANE_STATE_FRACTION = 0.25

#: bytes of per-lane state, fastSK's 28 fields with two pools live
#: during a compaction, rounded up for temporaries
_BYTES_PER_LANE = 27 * 4 * 4

#: build the (V, 4) fused albedo+density table only while it stays under
#: this fraction of the budget (Config.h's 80% threshold, applied to
#: the fused copy)
_FUSED_TABLE_FRACTION = 0.30


def device_memory_budget(device=None) -> int:
    """Total memory of `device` in bytes (reference: the deviceProp
    totalGlobalMem lookup, Config.h:119-130)."""
    device = torch.device(device or "cpu")
    if device.type == "cuda":
        return int(torch.cuda.mem_get_info(device)[1])
    return os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")


def grid_bytes(grid_shape_zyx: Tuple[int, ...], channels: int = 1) -> int:
    nz, ny, nx = grid_shape_zyx[:3]
    return nz * ny * nx * channels * 4


def plan_albedo_table(
    grid_shape_zyx: Tuple[int, ...], budget: Optional[int] = None,
    device=None,
) -> str:
    """'fused' | 'split' for a full per-voxel-albedo scene: whether the
    (V, 4) fused albedo+density copy fits comfortably.  Raises
    MemoryError when even the raw grids cannot fit."""
    budget = budget or device_memory_budget(device)
    fused = grid_bytes(grid_shape_zyx, 4)
    raw = grid_bytes(grid_shape_zyx, 1) + grid_bytes(grid_shape_zyx, 4)
    if raw > 0.8 * budget:
        raise MemoryError(
            f"scene grids need {raw / 2**30:.1f} GiB "
            f"(> 80% of the {budget / 2**30:.1f} GiB device budget); use a "
            "constant or density-affine albedo, or reduce the grid "
            "resolution"
        )
    if fused > _FUSED_TABLE_FRACTION * budget:
        return "split"
    return "fused"


def pick_n_lanes(
    n_pix: int,
    spp: int,
    grid_shape_zyx: Tuple[int, ...] = (1, 1, 1),
    budget: Optional[int] = None,
    lo: int = 1 << 12,
    hi: int = 1 << 17,
    device=None,
) -> int:
    """Wavefront pool width for the queue-fed schedulers: as wide as the
    work and the memory budget allow, clamped to [lo, hi], a multiple of
    256 lanes."""
    budget = budget or device_memory_budget(device)
    n_paths = n_pix * max(spp, 1)
    grids = grid_bytes(grid_shape_zyx, 5)  # density + albedo, worst case
    free = max(budget - grids, budget // 8)
    mem_cap = int(free * _LANE_STATE_FRACTION) // _BYTES_PER_LANE
    lanes = min(n_paths, mem_cap, hi)
    lanes = max(lanes, min(lo, n_paths))
    return max(256, (lanes // 256) * 256)


def validate_pool(n_lanes: int, grid_shape_zyx, budget=None, device=None) -> None:
    """Warn when an explicit pool width plus the grids exceed the budget
    (the reference warns rather than fails, Config.h:122-133)."""
    budget = budget or device_memory_budget(device)
    state = n_lanes * _BYTES_PER_LANE
    grids = grid_bytes(grid_shape_zyx, 5)
    if state + grids > budget:
        import warnings

        warnings.warn(
            f"wavefront state ({state / 2**30:.2f} GiB at {n_lanes} "
            f"lanes) plus grids ({grids / 2**30:.2f} GiB) exceeds the "
            f"device budget ({budget / 2**30:.1f} GiB); reduce "
            "n_lanes or the grid resolution",
            stacklevel=2,
        )


def autotune_report(n_pix, spp, grid_shape_zyx, budget=None, device=None) -> str:
    """Human-readable line mirroring the reference's occupancy printout
    (RenderKernelLauncher.cu:318-324); the JAX package's words."""
    budget = budget or device_memory_budget(device)
    lanes = pick_n_lanes(n_pix, spp, grid_shape_zyx, budget)
    return (
        f"[cvr-tpu] occupancy: pool {lanes} lanes "
        f"({lanes * _BYTES_PER_LANE / 2**20:.1f} MiB state), "
        f"budget {budget / 2**30:.1f} GiB, "
        f"work {n_pix * spp} paths"
    )
