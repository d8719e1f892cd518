"""fastSK: the streaming wavefront scheduler (port of
cudavolumerenderer_tpu/models/fast.py).

Same physics as the JAX scheduler and the same per-path draw sequences:

1. **Lane-pinned pixels** — lane i owns one pixel and renders its
   samples one after another into a lane-private accumulator.
2. **Fused albedo+density table** — one gather row gives the tap's
   density and, on a scatter, its albedo; a constant or density-affine
   albedo keeps the table a flat density vector.
3. **Stochastic trilinear filtering** — one tap drawn with probability
   equal to its trilerp weight; distribution-exact for Woodcock tracking.
4. **Cascade tail compaction** — pools of shrinking width; when the
   pending count fits the next pool, finished lanes flush to the image
   and pending lanes are stably compacted into it.
5. **Two-level sparse-leap tracking** (`two_level=True`) — per-brick
   dilated majorants and Chebyshev empty-space leaps in a small table.
6. **The persistent tail kernel** (`tail_pallas=True`, ops/tailpk.py) —
   once the pending count fits tail_pk_width lanes, a service round hands
   them to the CUDA kernel for K whole tracking steps; on the card the
   whole stage is one drain launch (ops/taildrain.py) in which each lane
   runs its rounds to its end, the eager loop (plain_round) its plain
   version.
7. **Multi-tile lane mode** — a (T, 2) tile_offset renders T tiles in one
   cascade, each lane carrying its tile through its pixel id.
8. **Deferred boundary events** (`defer_ggx=G`) — a lane at the box
   surface stalls and the GGX sampler runs for every stalled lane at once
   on a schedule read from the summed pool widths.
9. **Tail knobs** — finer brick tables in tail pools (`tail_bricks`),
   `tail_spec` Woodcock steps from one gather in pools up to `spec_width`
   lanes, under the global majorant with `tail_single_level`.
10. **Table layouts** — the (8, 8, 128) brick-major flat table
   (`brick_major`), and 'split' albedo: a full per-voxel albedo too big to
   copy into the fused table is gathered from the scene grid at accepted
   taps (utils/occupancy.plan_albedo_table).

Port notes: the jax while-loops are Python loops that read the pending
count on the host once per chained group of body evaluations (extra
evaluations past the exit condition are no-ops: draws are masked per
path); compaction gathers each field with index_select; the image is
accumulated with index_add_ of masked values; the defer_ggx schedule
reads a host float32 copy of n_rows, not the device's.  XLA compiled the
wavefront body into one device program on the TPU; on the card one
stage runs through csrc/fastbody.cu (ops/fastbody.run_stage) for
spec_k == 1 and defer_ggx == 0: chains of one-evaluation launches that
read the pending count on the card and return untouched once the loop
would have exited, the host reading it once per batch; and the last
stage without the tail kernel in one launch in which each lane runs to
its end.  The eager body below is its plain version: the CPU runs it, and
so do the speculative tail steps, the deferred GGX flush and callers that
pass eager_body=True.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..constants import EPSILON
from ..ops import aabb, camera as cam, fastbody, phase, stages, taildrain
from ..ops import tailpk as tpk
from ..ops.rng import M32, RngState, make_rng, next_float, next_uint32
from ..scene.types import RenderSettings, Scene
from . import integrator

# Default brick geometry for two-level tracking: (z, y, x) voxels per
# brick; pick_brick grows it per scene to keep the table small.
BRICK = (4, 4, 8)

# Keep the brick-majorant table at or under this many rows.
_MAX_BRICKS = 65536

# Cascade geometry: pool widths shrink by _CASCADE_FACTOR down to the
# minimum pool width (the JAX package's non-TPU default 4096; the H100
# value is unmeasured).
_CASCADE_FACTOR = 4
_MIN_WIDTH = 4096

# Distance-transform iterations: empty-space leaps up to this many
# bricks are collapsed into one wavefront iteration.
_LEAP_ITERS = 6

# Narrow tail pools chain this many body evaluations per pending-count
# read; speculation (tail_spec) is off by default.
_TAIL_CHAIN = 8
_TAIL_SPEC = 1
_TAIL_CHAIN_WIDTH = 16384


def _albedo_mode(scene: Scene, allow_split: bool = False) -> str:
    """'const' | 'affine' | 'full' | 'split' (the last only with
    allow_split, when the fused copy would not fit the device)."""
    med = scene.medium
    if all(s == 1 for s in med.albedo.data.shape[:3]):
        return "const"
    if med.albedo_affine is not None:
        return "affine"
    if allow_split:
        from ..utils import occupancy  # noqa: PLC0415

        if occupancy.plan_albedo_table(
            med.density.data.shape, device=med.density.data.device
        ) == "split":
            return "split"
    return "full"


def make_fused_grid(scene: Scene, mode: str = None) -> torch.Tensor:
    """(Z*Y*X, 4) rows of (albedo.rgb, density), or the flat (Z*Y*X,)
    density vector under a constant or density-affine albedo."""
    med = scene.medium
    if (mode or _albedo_mode(scene)) != "full":
        return med.density.data.reshape(-1)
    den = med.density.data.reshape(-1, 1)
    alb = med.albedo.data[..., :3].reshape(-1, 3)
    return torch.cat([alb, den], dim=-1)


def fused_row_decode(scene: Scene, row: torch.Tensor):
    """(rho, albedo.rgb) from fused-table gather rows (const/affine/full)."""
    mode = _albedo_mode(scene)
    if mode == "const":
        alb = scene.medium.albedo.data.reshape(-1)[:3]
        return row, alb.expand(row.shape + (3,))
    if mode == "affine":
        aff = scene.medium.albedo_affine
        return row, row[..., None] * aff[0] + aff[1]
    return row[..., -1], row[..., :3]


#: brick-major layout brick dims (z, y, x): the taps of an 8x8x128 brick
#: are contiguous in the flat table (the texture-locality analog,
#: CudaVolPath.cpp:118-186); the shifts and masks derive from it
_BM_BRICK = (8, 8, 128)
_BM_SHIFT = tuple(d.bit_length() - 1 for d in _BM_BRICK)  # (z, y, x)
_BM_MASK = tuple(d - 1 for d in _BM_BRICK)
assert all(1 << s == d for s, d in zip(_BM_SHIFT, _BM_BRICK))


def brick_major_table(density_zyx: torch.Tensor) -> torch.Tensor:
    """Flat density table in brick-major order ((8, 8, 128) bricks); the
    grid's dims must be multiples of the brick's."""
    nz, ny, nx = density_zyx.shape
    ez, ey, ex = _BM_BRICK
    assert nz % ez == 0 and ny % ey == 0 and nx % ex == 0
    return (
        density_zyx.reshape(nz // ez, ez, ny // ey, ey, nx // ex, ex)
        .permute(0, 2, 4, 1, 3, 5)
        .reshape(-1)
    )


def pick_brick(grid_shape_zyx, max_bricks: int = _MAX_BRICKS) -> Tuple[int, int, int]:
    """Smallest brick (tightest majorants) whose brick count fits
    max_bricks."""
    nz, ny, nx = grid_shape_zyx
    for bz, by, bx in (
        (4, 4, 4), (4, 4, 8), (8, 8, 8), (8, 8, 16), (16, 16, 16),
        (16, 16, 32), (32, 32, 32), (32, 32, 64),
    ):
        n_bricks = -(-nz // bz) * -(-ny // by) * -(-nx // bx)
        if n_bricks <= max_bricks:
            return (bz, by, bx)
    return (64, 64, 64)


def brick_majorants(
    density_zyx: torch.Tensor, brick: Tuple[int, int, int] = BRICK
) -> torch.Tensor:
    """Per-brick *dilated* majorants: max over the brick's voxels plus a
    one-voxel border on the high side, so any trilinear tap reachable
    from inside the brick is covered.  Window b+1, stride b; the -inf pad
    goes on the high side only (max_pool3d's own padding is symmetric)."""
    bz, by, bx = brick
    nz, ny, nx = density_zyx.shape
    nbz, nby, nbx = -(-nz // bz), -(-ny // by), -(-nx // bx)
    padded = F.pad(
        density_zyx[None, None],
        (0, nbx * bx + 1 - nx, 0, nby * by + 1 - ny, 0, nbz * bz + 1 - nz),
        value=-math.inf,
    )
    return F.max_pool3d(
        padded, kernel_size=(bz + 1, by + 1, bx + 1), stride=(bz, by, bx)
    )[0, 0]


def brick_chebyshev_distance(brick_major: torch.Tensor) -> torch.Tensor:
    """Chebyshev brick-distance to the nearest non-empty brick, exact up
    to _LEAP_ITERS and capped there.  0 for non-empty bricks.  A min-pool
    is a max-pool of the negation; its implicit pad is +inf."""
    dist = torch.where(brick_major > 0.0, 0.0, 1e9)
    for _ in range(_LEAP_ITERS):
        nearest = -F.max_pool3d(-dist[None, None], 3, stride=1, padding=1)[0, 0]
        dist = torch.minimum(dist, nearest + 1.0)
    return torch.clamp(dist, max=float(_LEAP_ITERS + 1))


class FastState(NamedTuple):
    o: torch.Tensor  # (N, 3)
    d: torch.Tensor  # (N, 3)
    throughput: torch.Tensor  # (N, 3)
    accum: torch.Tensor  # (N, 3) lane-private radiance over finished paths
    normal: torch.Tensor  # (N, 3)
    t: torch.Tensor  # (N,)
    max_t: torch.Tensor  # (N,)
    brick_exit: torch.Tensor  # (N,) t at which the ray leaves its brick
    inv_sig_local: torch.Tensor  # (N,) 1/(scale*rho_max_brick)
    pix: torch.Tensor  # (N,) int64 tile-local pixel id (travels with lane)
    slot: torch.Tensor  # (N,) int64 lanes-per-pixel slot
    samples_done: torch.Tensor  # (N,) int64 completed paths per lane
    bounce: torch.Tensor  # (N,) int64 events on the current path
    alive: torch.Tensor  # (N,) bool current path in flight
    tracking: torch.Tensor  # (N,) bool
    rng: RngState
    n_rays: torch.Tensor  # () f32 traced rays
    n_rows: torch.Tensor  # () f32 — sum over iterations of pool width
    n_busy: torch.Tensor  # () f32 — sum over iterations of tracking lanes
    pend_b: torch.Tensor  # (N,) bool waiting for the deferred boundary flush


def _take_lanes(s, idx: torch.Tensor):
    """The lanes `idx` of every per-lane field of a state tuple (cascade
    compaction here, the sort permutation in models/brick.py); 0-d
    counters stay as they are."""
    def take(v):
        if isinstance(v, RngState):
            return RngState(v.state.index_select(0, idx),
                            v.inc.index_select(0, idx))
        return v if v.ndim == 0 else v.index_select(0, idx)

    return type(s)(*(take(v) for v in s))


def _stochastic_tap(coord, f_bits):
    """Pick the trilerp tap: per axis, the upper neighbor with probability
    frac(coord).  f_bits: 30 random bits (10 per axis) from one draw."""
    c0 = torch.floor(coord)
    frac = coord - c0
    i0 = c0.to(torch.int64)
    u = torch.stack(
        [((f_bits >> s) & 0x3FF).to(torch.float32) * (1.0 / 1024.0)
         for s in (0, 10, 20)],
        dim=-1,
    )
    return i0 + (u < frac).to(torch.int64)


def first_stop(stopj: torch.Tensor):
    """(column of each row's first True, whether the row has one) of an
    (N, K) bool tensor: jnp.argmax's first maximum, taken over integers
    (an all-false row gives column 0, which its callers leave unused)."""
    return torch.argmax(stopj.to(torch.int32), dim=-1), stopj.any(dim=-1)


def read_prefix(acceptj: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """The speculative candidates whose table rows a lane's step needs, of
    (N, K) bool tensors: the valid ones up to and including the first
    acceptance, all valid ones where none accepts (an invalid candidate
    reads no row, and its t ends the step)."""
    j0, any_stop = first_stop(acceptj | ~valid)
    cols = torch.arange(valid.shape[-1], device=valid.device)
    return valid & ((cols <= j0[:, None]) | ~any_stop[:, None])


def _cascade_widths(
    n_lanes: int, factor: float = _CASCADE_FACTOR,
    min_width: int = _MIN_WIDTH,
):
    """Pool widths for the tail-compaction cascade; widths quantize to
    multiples of 256, and fractional factors stall where
    ceil(w/factor/256)*256 == w."""
    widths = [n_lanes]
    while widths[-1] > min_width:
        nxt = max(
            min_width,
            int(math.ceil(widths[-1] / float(factor) / 256.0)) * 256,
        )
        if nxt >= widths[-1]:
            break
        widths.append(nxt)
    return widths


def quantize_density(g: torch.Tensor, max_density, bits: int) -> torch.Tensor:
    """round(clip(g / max_density, 0, 1) * qmax), qmax = 2^bits - 1, as
    float: the level each voxel is stored at."""
    qmax = float((1 << bits) - 1)
    return torch.round(torch.clamp(g / max_density, 0.0, 1.0) * qmax)


def dequant_grid(g: torch.Tensor, max_density, bits: int) -> torch.Tensor:
    """A density grid round-tripped through the quantizer: the values the
    packed table's taps see, so the majorants are built from it."""
    return quantize_density(g, max_density, bits) * (
        max_density / float((1 << bits) - 1))


def pack_density(flat: torch.Tensor, max_density, bits: int) -> torch.Tensor:
    """The packed table of a flat density vector: per = 32 / bits levels in
    each 32-bit word, strided by 128 rows.  Voxel j sits at (r, c) =
    (j >> 7, j & 127) of a (R, 128) view padded to a multiple of
    128 * 2 * per voxels; it lands in word (r // per) * 128 + c at shift
    (r % per) * bits.  The words are uint32 in JAX; here they are int32
    with the same bits.  JAX stores them as (Vp, 2) word pairs where that
    suits the TPU's tiling, which changes no value; this is one flat word
    table."""
    per = 32 // bits
    q = quantize_density(flat, max_density, bits).to(torch.int64)
    pad = (-q.numel()) % (128 * 2 * per)
    q2 = torch.cat([q, q.new_zeros(pad)]).reshape(-1, 128)
    words = q.new_zeros((q2.shape[0] // per, 128))
    for k in range(per):
        words |= q2[k::per] << (k * bits)
    words = torch.where(words >= 1 << 31, words - (1 << 32), words)
    return words.to(torch.int32).reshape(-1)


def packed_take(words: torch.Tensor, j: torch.Tensor, max_density,
                bits: int) -> torch.Tensor:
    """Density at flat voxel index j (any shape) from `pack_density`'s
    table, dequantized."""
    per = 32 // bits
    r, c = j >> 7, j & 127
    word = words[(r // per) * 128 + c]
    level = (word >> ((r % per) * bits).to(torch.int32)) & ((1 << bits) - 1)
    return level.to(torch.float32) * (max_density / float((1 << bits) - 1))


def render_tile(
    scene: Scene,
    camera: cam.Camera,
    settings: RenderSettings,
    tile_dim: Tuple[int, int],
    tile_offset,
    full_resolution: Tuple[int, int],
    spp: int,
    seed,
    path_id_base,
    lanes_per_pixel: int = 1,
    two_level: bool = False,
    with_stats: bool = False,
    max_bricks: int = _MAX_BRICKS,
    brick_size: Tuple[int, int, int] = None,
    table_bits: int = 32,
    defer_ggx: int = 0,
    brick_major: bool = False,
    cascade_factor: float = _CASCADE_FACTOR,
    tail_chain: int = _TAIL_CHAIN,
    tail_spec: int = _TAIL_SPEC,
    tail_width: int = _TAIL_CHAIN_WIDTH,
    spec_width: int = None,
    min_width: int = None,
    tail_single_level: bool = False,
    tail_bricks: int = 0,
    tail_pallas: bool = False,
    tail_pk_width: int = 128,
    tail_pk_steps: int = 16,
    eager_body: bool = False,
):
    """Render spp samples of every pixel of one tile.  Returns
    (img (th, tw, 3), n_rays) — with with_stats, also (n_rows, n_busy,
    per-stage rows), the last stage being the tail kernel's when it ran.

    Multi-tile lane mode: a tile_offset shaped (T, 2) with a (T,)
    path_id_base renders all T tiles in one cascade and returns img
    (T, th, tw, 3).  Lanes cover T*tw*th pixels; the tile index is
    pix // (tw*th), so it travels with the lane through compaction, and
    each lane takes its tile's origin and path-id base.  Path ids and
    camera jitter are the per-tile calls', so the tiles equal the
    sequential per-tile renders bit for bit (the tail kernel stays off:
    its service loop is single-tile).

    defer_ggx = G > 0 batches boundary events: a lane that reaches the
    box surface stalls (pend_b) and the GGX sampler runs for all pending
    lanes when round(n_rows / width) % G == 0, n_rows being the float32
    sum of every evaluation's pool width over all stages.  A lane's draws
    keep their place in its own stream, so the image and n_rays equal
    defer_ggx=0's; the schedule (and so with_stats' rows) is JAX's.

    Tail pools (width <= tail_width) may probe a finer brick table
    (tail_bricks); pools of width <= spec_width (default tail_width) take
    tail_spec Woodcock steps per evaluation from one gather, under the
    global majorant with tail_single_level.  brick_major stores a flat
    table in (8, 8, 128) bricks when the grid divides them."""
    dev = scene.device
    tile_offset = torch.as_tensor(tile_offset, dtype=torch.float32, device=dev)
    if table_bits not in (32, 8, 4):
        raise ValueError("table_bits must be 32, 8 or 4")
    tw, th = tile_dim
    n_pix_tile = tw * th
    multi_t = tile_offset.ndim == 2
    n_tiles_batch = tile_offset.shape[0] if multi_t else 1
    n_pix = n_pix_tile * n_tiles_batch
    m = lanes_per_pixel
    while spp % m != 0:
        m -= 1
    spp_per_lane = spp // m
    n_lanes = n_pix * m
    med = scene.medium

    nz, ny, nx = med.density.data.shape
    res_minus_1 = torch.tensor(
        [nx - 1, ny - 1, nz - 1], dtype=torch.float32, device=dev
    )
    extent = med.box_max - med.box_min
    scale = med.scale
    inv_sigmat = 1.0 / (scale * med.max_density)
    albedo_mode = _albedo_mode(scene, allow_split=True)
    flat_tab = albedo_mode != "full"  # 1-D density-only table
    ez_bm, ey_bm, ex_bm = _BM_BRICK
    use_bm = (
        brick_major and flat_tab and albedo_mode != "split"
        and nz % ez_bm == 0 and ny % ey_bm == 0 and nx % ex_bm == 0
    )
    if use_bm:
        fused = brick_major_table(med.density.data)
    else:
        fused = make_fused_grid(scene, albedo_mode)
    if albedo_mode == "split":
        # rows of the scene's own albedo grid (a view: no copy of it)
        albedo_rows = med.albedo.data.reshape(-1, med.albedo.data.shape[-1])
    # table_bits 8/4: the flat table packed at 2^bits levels; each tap's
    # acceptance is then off by at most 1/(2^(bits+1)-2) of max_density,
    # and the majorants come from the dequantized grid so they bound
    # every tap
    use_packed = table_bits in (8, 4) and flat_tab
    if use_packed:
        words = pack_density(fused, med.max_density, table_bits)

        def fused_take(j):
            return packed_take(words, j, med.max_density, table_bits)

        def majorant_grid(g):
            return dequant_grid(g, med.max_density, table_bits)
    else:
        def fused_take(j):
            return fused[j]

        def majorant_grid(g):
            return g

    def row_rho(row):
        return row if flat_tab else row[..., -1]

    def tap_flat_idx(ix, iy, iz):
        """Flat table index of a clamped integer tap, row-major or
        brick-major."""
        if not use_bm:
            return (iz * ny + iy) * nx + ix
        sz, sy, sx = _BM_SHIFT
        mz, my, mx = _BM_MASK
        return (
            (((iz >> sz) * (ny // ey_bm) + (iy >> sy)) * (nx // ex_bm)
             + (ix >> sx)) * (ez_bm * ey_bm * ex_bm)
            + (((iz & mz) << (sy + sx)) + ((iy & my) << sx) + (ix & mx))
        )

    def tap_albedo(row, tap_flat, mask):
        """Scatter albedo for lanes in `mask`: decoded from the fused row,
        or under 'split' gathered from the scene's albedo grid at the
        accepted tap."""
        if albedo_mode == "split":
            return albedo_rows[torch.where(mask, tap_flat, 0)][..., :3]
        return fused_row_decode(scene, row)[1]

    def build_brick_tables(bz_, by_, bx_):
        """Majorant + leap table for one brick granularity.  Stages may
        use different granularities: a lane's carried (brick_exit,
        inv_sig_local) stays a valid majorant until its next crossing,
        so switching tables at a stage boundary needs no re-probe."""
        nbz, nby, nbx = -(-nz // bz_), -(-ny // by_), -(-nx // bx_)
        major = brick_majorants(majorant_grid(med.density.data),
                                (bz_, by_, bx_))
        # world-space edge of the safe Chebyshev ball around a brick
        edge_world = torch.tensor(
            [bx_, by_, bz_], dtype=torch.float32, device=dev
        ) * (extent / res_minus_1)
        min_edge = torch.amin(edge_world)
        cheb = brick_chebyshev_distance(major)
        # safe leap beyond the brick exit: (D-1) empty rings, shaved by
        # an epsilon so float rounding cannot poke past the guarantee
        leap = torch.clamp(cheb - 1.0, min=0.0) * min_edge * (1.0 - 1e-6)
        return dict(
            tab=torch.stack([major.reshape(-1), leap.reshape(-1)], dim=-1),
            size=torch.tensor(
                [bx_, by_, bz_], dtype=torch.float32, device=dev
            ),
            hi=torch.tensor(
                [nbx - 1, nby - 1, nbz - 1], dtype=torch.int64, device=dev
            ),
            nby=nby, nbx=nbx,
        )

    coarse_bt = fine_bt = None
    if two_level:
        coarse_bt = build_brick_tables(
            *(brick_size or pick_brick((nz, ny, nx), max_bricks))
        )
        # tail pools are latency-bound: tighter majorants cut the null
        # collisions of the few deep paths left
        if tail_bricks > 0:
            fine_bt = build_brick_tables(tail_bricks, tail_bricks, tail_bricks)

    lane = torch.arange(n_lanes, dtype=torch.int64, device=dev)
    if multi_t:
        bases = torch.as_tensor(path_id_base, dtype=torch.int64, device=dev) & M32

        def path_id_of(pix, slot, samples_done):
            s = slot + m * samples_done
            local = pix % n_pix_tile
            return (s * n_pix_tile + local + bases[pix // n_pix_tile]) & M32

        def pixel_xy_of(pix):
            local = pix % n_pix_tile
            off = tile_offset[pix // n_pix_tile]
            px = (local % tw).to(torch.float32) + off[:, 0]
            py = torch.floor(local.to(torch.float32) / tw) + off[:, 1]
            return torch.stack([px, py], dim=-1)
    else:
        base = int(path_id_base) & M32

        def path_id_of(pix, slot, samples_done):
            s = slot + m * samples_done
            return (s * n_pix + pix + base) & M32

        def pixel_xy_of(pix):
            px = (pix % tw).to(torch.float32) + tile_offset[0]
            py = torch.floor(pix.to(torch.float32) / tw) + tile_offset[1]
            return torch.stack([px, py], dim=-1)

    def zeros(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=dev)

    state = FastState(
        o=zeros(n_lanes, 3),
        d=torch.tensor([0.0, 0.0, 1.0], device=dev).repeat(n_lanes, 1),
        throughput=torch.ones((n_lanes, 3), device=dev),
        accum=zeros(n_lanes, 3), normal=zeros(n_lanes, 3),
        t=zeros(n_lanes), max_t=zeros(n_lanes),
        brick_exit=torch.full((n_lanes,), -1.0, device=dev),
        inv_sig_local=zeros(n_lanes),
        pix=lane % n_pix, slot=lane // n_pix,
        samples_done=zeros(n_lanes, dtype=torch.int64),
        bounce=zeros(n_lanes, dtype=torch.int64),
        alive=zeros(n_lanes, dtype=torch.bool),
        tracking=zeros(n_lanes, dtype=torch.bool),
        rng=make_rng(seed, zeros(n_lanes, dtype=torch.int64)),
        n_rays=zeros(), n_rows=zeros(), n_busy=zeros(),
        pend_b=zeros(n_lanes, dtype=torch.bool),
    )

    def cap_and_roulette(alive, samples_done, bounce, tput, rng, event,
                         cap_on):
        """After `event` lanes took an event (bounce already counted):
        the path-length cap on `cap_on` lanes, then Russian roulette on
        the event lanes that were not capped."""
        capped = cap_on & (bounce >= settings.max_path_length)
        alive = alive & ~capped
        samples_done = torch.where(capped, samples_done + 1, samples_done)
        if settings.russian_roulette:
            tput, alive, killed, rng = integrator.russian_roulette(
                tput, alive, rng, event & ~capped
            )
            samples_done = torch.where(killed, samples_done + 1, samples_done)
        return alive, samples_done, tput, rng, capped

    def flush_boundary(s: FastState) -> FastState:
        """The boundary event of every pending lane in one batched GGX
        evaluation, in the inline order: event, bounce + 1, path cap,
        Russian roulette."""
        pend = s.pend_b
        o_bound = s.o + s.d * s.max_t[:, None]
        o_b, d_b, t_b, rng = integrator.boundary_event(
            scene, settings, s.normal, o_bound, s.d, s.throughput, s.rng,
            pend,
        )
        p3 = pend[:, None]
        bounce = torch.where(pend, s.bounce + 1, s.bounce)
        alive, samples_done, tput, rng, _ = cap_and_roulette(
            s.alive, s.samples_done, bounce, torch.where(p3, t_b, s.throughput),
            rng, event=pend, cap_on=pend,
        )
        return s._replace(
            o=torch.where(p3, o_b, s.o), d=torch.where(p3, d_b, s.d),
            throughput=tput, bounce=bounce, alive=alive,
            samples_done=samples_done, rng=rng,
            pend_b=torch.zeros_like(pend),
        )

    def body(s: FastState, spec_k=1, single_level=False, bt=None,
             taps=None) -> FastState:
        """One evaluation of every lane; a list given as `taps` receives
        the flat table indices and brick rows the evaluation reads and its
        per-lane state traffic (fastbody.body_bytes)."""
        width = s.alive.shape[0]
        # --- regenerate: next sample of the lane's pixel -----------------
        needs = ~s.alive & (s.samples_done < spp_per_lane)
        fresh = make_rng(seed, path_id_of(s.pix, s.slot, s.samples_done))
        rng = RngState(
            state=torch.where(needs, fresh.state, s.rng.state),
            inc=torch.where(needs, fresh.inc, s.rng.inc),
        )
        o_new, d_new, rng = cam.generate_rays(
            camera, pixel_xy_of(s.pix), full_resolution, rng, active=needs
        )
        mm = needs[:, None]
        o = torch.where(mm, o_new, s.o)
        d = torch.where(mm, d_new, s.d)
        tput = torch.where(mm, 1.0, s.throughput)
        alive = s.alive | needs
        tracking = s.tracking & ~needs
        bounce = torch.where(needs, 0, s.bounce)

        # --- segment start: AABB + classification ------------------------
        need_isect = alive & ~tracking
        if defer_ggx > 0:
            need_isect = need_isect & ~s.pend_b  # stalled for the flush
        n_rays = s.n_rays + need_isect.to(torch.float32).sum()
        isect = aabb.aabb_intersect(med.box_min, med.box_max, o, d)
        miss = need_isect & ~isect.hit
        accum = torch.where(miss[:, None], s.accum + tput * scene.le, s.accum)
        samples_done = torch.where(miss, s.samples_done + 1, s.samples_done)
        alive = alive & ~miss
        enters = need_isect & isect.hit & isect.inside_volume
        boundary_now = need_isect & isect.hit & ~isect.inside_volume
        tracking = tracking | enters
        t = torch.where(enters, 0.0, s.t)
        max_t = torch.where(enters, isect.dist, s.max_t)
        normal = torch.where(need_isect[:, None], isect.normal, s.normal)
        brick_exit = torch.where(enters, -1.0, s.brick_exit)
        inv_sig_local = s.inv_sig_local

        def tap_flat(t_at, bits):
            """Flat table index of the stochastic tap at o + t_at d."""
            p_at = o + t_at[:, None] * d
            coord = (
                torch.clamp((p_at - med.box_min) / extent, 0.0, 1.0)
                * res_minus_1
            )
            tap = _stochastic_tap(coord, bits)
            return tap_flat_idx(
                torch.clamp(tap[:, 0], 0, nx - 1),
                torch.clamp(tap[:, 1], 0, ny - 1),
                torch.clamp(tap[:, 2], 0, nz - 1),
            )

        def speculate(rng, mask, inv_sig, t_end, strict):
            """spec_k Woodcock steps from one gather: spec_k u1 draws,
            then spec_k tap draws, then spec_k u2 draws, each masked per
            candidate.  A candidate is valid while it stays before t_end
            (strictly for a brick exit, not for the box's max_t); the
            prefix stops at the first acceptance or invalid candidate.
            Returns (stopped, accepted at the stop, t of the stop or of
            the last candidate, the stop's row and tap, rng)."""
            t_run, cands = t, []
            for _ in range(spec_k):
                u1, rng = next_float(rng, mask)
                t_run = t_run + torch.where(
                    mask, -torch.log(torch.clamp(u1, min=EPSILON)) * inv_sig,
                    0.0,
                )
                cands.append(t_run)
            t_cands = torch.stack(cands, dim=-1)  # (N, K)
            before = (t_cands < t_end[:, None]) if strict else (
                t_cands <= t_end[:, None])
            valid = mask[:, None] & before
            flats = []
            for j in range(spec_k):
                bits, rng = next_uint32(rng, valid[:, j])
                flats.append(tap_flat(t_cands[:, j], bits))
            idxk = torch.stack(flats, dim=-1)  # (N, K)
            rows = fused_take(torch.where(valid, idxk, 0))  # (N, K[, 4])
            u2s = []
            for j in range(spec_k):
                u2, rng = next_float(rng, valid[:, j])
                u2s.append(u2)
            u2k = torch.stack(u2s, dim=-1)
            acceptj = valid & ~(scale * row_rho(rows) * inv_sig[:, None] < u2k)
            if taps is not None:
                taps.append(("tap", idxk[read_prefix(acceptj, valid)]))
            j0, any_stop = first_stop(acceptj | ~valid)
            j0 = j0[:, None]
            if flat_tab:
                row0 = rows.gather(1, j0)[:, 0]
            else:
                row0 = rows.gather(
                    1, j0[:, :, None].expand(-1, 1, rows.shape[-1]))[:, 0]
            acc0 = acceptj.gather(1, j0)[:, 0]
            t_stop = torch.where(
                any_stop, t_cands.gather(1, j0)[:, 0], t_cands[:, -1])
            return (any_stop, acc0, t_stop, row0, idxk.gather(1, j0)[:, 0],
                    rng)

        # --- tracking ------------------------------------------------------
        if two_level and not single_level:
            # Two-level (sparse-leap) delta tracking: brick probes hit the
            # small (B, 2) majorant+leap table, taps the fused table; a
            # brick entry probes AND takes its first Woodcock step in the
            # same iteration, empty bricks leap (D-1) brick edges at once.
            epsw = torch.amax(extent) * 1e-6
            need_brick = tracking & (t >= brick_exit)
            p_now = o + (t + epsw)[:, None] * d
            coordn = (
                torch.clamp((p_now - med.box_min) / extent, 0.0, 1.0)
                * res_minus_1
            )
            bi = torch.minimum(
                torch.clamp(
                    torch.floor(coordn / bt["size"]).to(torch.int64), min=0
                ),
                bt["hi"],
            )
            bflat = (bi[:, 2] * bt["nby"] + bi[:, 1]) * bt["nbx"] + bi[:, 0]
            row_b = bt["tab"][torch.where(need_brick, bflat, 0)]
            rho_b, leap_b = row_b[:, 0], row_b[:, 1]
            if taps is not None:
                taps.append(("brick", bflat[need_brick]))

            # fresh DDA brick exit for probing lanes
            up = (d > 0.0).to(torch.float32)
            bound_coord = (bi.to(torch.float32) + up) * bt["size"]
            bound_world = med.box_min + extent * bound_coord / res_minus_1
            okd = torch.abs(d) > 1e-12
            t_axes = torch.where(
                okd, (bound_world - o) / torch.where(okd, d, 1.0), torch.inf
            )
            exit_new = torch.maximum(torch.amin(t_axes, dim=-1), t + epsw)
            brick_exit = torch.where(need_brick, exit_new, brick_exit)
            inv_new = torch.where(
                rho_b > 0.0,
                1.0 / (scale * torch.clamp(rho_b, min=1e-30)),
                torch.inf,
            )
            inv_sig_local = torch.where(need_brick, inv_new, inv_sig_local)

            # empty bricks: leap the whole guaranteed-empty Chebyshev ball
            probe_empty = need_brick & (rho_b <= 0.0)
            t_leap = torch.maximum(exit_new, t + leap_b)
            overran_empty = probe_empty & (t_leap >= max_t)

            # every lane with a live finite majorant steps this iteration
            stepping = tracking & ~probe_empty
            eff_exit = torch.minimum(brick_exit, max_t)

            if spec_k == 1:
                u1, rng = next_float(rng, stepping)
                step = torch.where(
                    stepping,
                    -torch.log(torch.clamp(u1, min=EPSILON)) * inv_sig_local,
                    0.0,
                )
                t_cand = t + step
                crossed_step = stepping & (t_cand >= eff_exit)
                inside = stepping & ~crossed_step
                tap_bits, rng = next_uint32(rng, inside)
                flat = tap_flat(t_cand, tap_bits)
                row = fused_take(torch.where(inside, flat, 0))
                if taps is not None:
                    taps.append(("tap", flat[inside]))
                u2, rng = next_float(rng, inside)
                accepted = inside & ~(
                    scale * row_rho(row) * inv_sig_local < u2)
                alb_hat = tap_albedo(row, flat, accepted)
                advance, t_adv = inside, t_cand
            else:
                # speculative steps: keep the prefix up to the first
                # acceptance or brick crossing (thinned steps are iid, so
                # the prefix is the same stochastic process)
                any_stop, acc0, t_adv, row0, tap0, rng = speculate(
                    rng, stepping, inv_sig_local, eff_exit, strict=True)
                accepted = stepping & any_stop & acc0
                crossed_step = stepping & any_stop & ~acc0
                alb_hat = tap_albedo(row0, tap0, accepted)
                # no stop within K valid steps: advance and keep tracking
                advance = stepping & (accepted | ~any_stop)

            overran_step = crossed_step & (max_t <= brick_exit)
            transit = crossed_step & ~overran_step
            t = torch.where(
                probe_empty,
                torch.minimum(t_leap, max_t),
                torch.where(
                    transit,
                    brick_exit,
                    torch.where(
                        overran_step,
                        torch.maximum(t, max_t),
                        torch.where(advance, t_adv, t),
                    ),
                ),
            )
            # leaping lanes re-probe wherever they landed
            brick_exit = torch.where(probe_empty, -1.0, brick_exit)
            overran = overran_step | overran_empty
            terminated = overran | accepted
            scattered = accepted
            tracking = tracking & ~terminated
        elif spec_k == 1:
            # single-level Woodcock tracking under the global majorant
            step_mask = tracking
            u1, rng = next_float(rng, step_mask)
            step = -torch.log(torch.clamp(u1, min=EPSILON)) * inv_sigmat
            t_new = torch.where(step_mask, t + step, t)
            tap_bits, rng = next_uint32(rng, step_mask)
            flat = tap_flat(t_new, tap_bits)
            row = fused_take(flat)
            if taps is not None:
                taps.append(("tap", flat[step_mask]))
            u2, rng = next_float(rng, step_mask)
            overran = t_new > max_t
            accepted = ~(scale * row_rho(row) * inv_sigmat < u2)
            terminated = step_mask & (overran | accepted)
            scattered = terminated & ~overran
            alb_hat = tap_albedo(row, flat, scattered)
            t = t_new
            tracking = tracking & ~terminated
        else:
            # speculative single-level steps: no brick crossings, so every
            # candidate before the box exit is a valid Woodcock step
            step_mask = tracking
            any_stop, acc0, t_stop, row0, tap0, rng = speculate(
                rng, step_mask, inv_sigmat.expand(t.shape), max_t,
                strict=False)
            accepted = step_mask & any_stop & acc0
            overran = step_mask & any_stop & ~acc0
            terminated = accepted | overran
            scattered = accepted
            alb_hat = tap_albedo(row0, tap0, scattered)
            t = torch.where(step_mask, t_stop, t)
            tracking = tracking & ~terminated

        # --- boundary event ----------------------------------------------
        boundary = boundary_now | (terminated & overran)
        pend_b = s.pend_b
        if defer_ggx > 0:
            # record the boundary distance and stall; flush_boundary runs
            # the event later at the same place in the lane's stream
            max_t = torch.where(boundary_now, isect.dist, max_t)
            pend_b = pend_b | boundary
            boundary = torch.zeros_like(boundary)
        else:
            o_bound = torch.where(
                boundary_now[:, None],
                o + d * isect.dist[:, None],
                o + d * max_t[:, None],
            )
            o_b, d_b, t_b, rng = integrator.boundary_event(
                scene, settings, normal, o_bound, d, tput, rng, boundary
            )

        # --- scatter event: reuse the accepted tap's albedo --------------
        o_s = o + d * t[:, None] - d * EPSILON
        d_s, rng = phase.sample_phase(d, med.g, rng, active=scattered)
        sc, bd = scattered[:, None], boundary[:, None]
        if defer_ggx > 0:
            o = torch.where(sc, o_s, o)
            d = torch.where(sc, d_s, d)
            tput = torch.where(sc, tput * alb_hat, tput)
        else:
            o = torch.where(sc, o_s, torch.where(bd, o_b, o))
            d = torch.where(sc, d_s, torch.where(bd, d_b, d))
            tput = torch.where(sc, tput * alb_hat, torch.where(bd, t_b, tput))

        # --- path-length cap + Russian roulette after events --------------
        had_event = alive & (scattered | boundary)
        bounce = torch.where(had_event, bounce + 1, bounce)
        alive, samples_done, tput, rng, capped = cap_and_roulette(
            alive, samples_done, bounce, tput, rng, event=had_event,
            cap_on=alive)
        tracking = tracking & ~capped

        new = FastState(
            o=o, d=d, throughput=tput, accum=accum, normal=normal,
            t=t, max_t=max_t,
            brick_exit=brick_exit, inv_sig_local=inv_sig_local,
            pix=s.pix, slot=s.slot,
            samples_done=samples_done, bounce=bounce,
            alive=alive, tracking=tracking,
            rng=rng, n_rays=n_rays,
            n_rows=s.n_rows + float(width),
            n_busy=s.n_busy + tracking.to(torch.float32).sum(),
            pend_b=pend_b,
        )
        if taps is not None:
            # the lanes whose evaluation reads each field before it writes
            # it (a regenerated lane writes its path's fields unread)
            none = torch.zeros_like(s.alive)
            live, trk = s.alive, s.alive & s.tracking
            two = two_level and not single_level
            drew = stages.changed(s.rng.state, rng.state) & ~needs
            ggx_on = settings.bsdf_kind == "ggx"
            rr = settings.russian_roulette
            reads = {
                "alive": torch.ones_like(live), "tracking": live,
                "samples_done": ~live | (samples_done != s.samples_done),
                "pix": needs, "slot": needs, "o": live, "d": live,
                "throughput": live & (miss | scattered
                                      | (boundary if ggx_on else none)
                                      | (had_event if rr else none)),
                "accum": miss,
                "normal": boundary & ~boundary_now if ggx_on else none,
                "t": trk, "max_t": trk,
                "brick_exit": trk if two else none,
                "inv_sig_local": trk & ~need_brick if two else none,
                "bounce": had_event, "rng_state": drew, "rng_inc": drew,
            }
            if defer_ggx > 0:
                reads["pend_b"] = live & ~s.tracking
            taps.append(("state", stages.lane_traffic(
                s, new, reads, fastbody.state_fields(defer_ggx))))
        return new

    def evaluate(s: FastState, taps=None, **kw) -> FastState:
        """One evaluation as the kernel runs it (the stage's plain
        version): the deferred GGX flush where the schedule, read from
        s.n_rows, says so (fastbody.flush_due), then the body."""
        width = s.alive.shape[0]
        if fastbody.flush_due(float(s.n_rows), width, defer_ggx):
            flushed = flush_boundary(s)
            if taps is not None:
                # the waiting lanes read their event's fields; every live
                # lane its flag
                pend, none = s.pend_b, torch.zeros_like(s.pend_b)
                reads = {k: none for k in fastbody.state_fields(defer_ggx)
                         if not k.startswith("rng")}
                reads.update(
                    alive=pend, pend_b=s.alive, o=pend, d=pend, normal=pend,
                    max_t=pend, throughput=pend, bounce=pend,
                    samples_done=flushed.samples_done != s.samples_done)
                taps.append(("state", stages.lane_traffic(
                    s, flushed, reads, fastbody.state_fields(defer_ggx))))
            s = flushed
        return body(s, taps=taps, **kw)

    def pending_of(s):
        return s.alive | (s.samples_done < spp_per_lane)

    # the flush schedule reads n_rows; a host copy, summed in float32 in
    # the same order, equals the device's bit for bit without a read
    rows_host = np.float32(0.0)

    def step(s: FastState, **kw) -> FastState:
        """One evaluation of the eager body (after the deferred GGX flush
        when its schedule says so)."""
        nonlocal rows_host
        width = s.alive.shape[0]
        if fastbody.flush_due(rows_host, width, defer_ggx):
            s = flush_boundary(s)
        rows_host = np.float32(rows_host + np.float32(width))
        return body(s, **kw)

    # the cascade: shrink the pool as the tail empties
    if min_width is None:
        min_width = _MIN_WIDTH
    widths = _cascade_widths(n_lanes, cascade_factor, min_width)
    plan = stage_plan(widths, tail_width, spec_width, tail_spec,
                      tail_single_level, two_level, tail_chain)

    # the kernel's parameters, read back to the host once per render; a
    # stage's spec_k beyond the kernel's raises here, before any work
    base_ctx = None
    if fastbody.route(dev.type, max(p["spec_k"] for p in plan), eager_body):
        base_ctx = fastbody.make_context(
            scene, camera, settings, full_resolution, tile_dim, tile_offset,
            path_id_base, seed, spp_per_lane=spp_per_lane, m=m,
            n_pix_tile=n_pix_tile, res_minus_1=res_minus_1, extent=extent,
            inv_sigmat=inv_sigmat, epsw=torch.amax(extent) * 1e-6,
            two_level=two_level, table=words if use_packed else fused,
            table_bits=table_bits, brick_major=use_bm,
            albedo_mode=albedo_mode,
            albedo_rows=albedo_rows if albedo_mode == "split" else None,
            defer_ggx=defer_ggx,
        )

    # the tail kernel takes over once the pending count fits its width;
    # it rebuilds albedo as A*rho+B, so it needs a const/affine albedo
    # (a full-albedo scene keeps the wavefront tail), runs boundary events
    # inline (not under defer_ggx), reads the f32 grid (so not under
    # packed tables), and its service loop is single-tile
    use_tailpk = (
        tail_pallas and albedo_mode in ("const", "affine") and defer_ggx == 0
        and not use_packed and not multi_t
    )
    pk_width = min(tail_pk_width, n_lanes)
    img = torch.zeros((n_pix, 3), dtype=torch.float32, device=dev)
    stage_rows = []

    def flush_compact(s: FastState, img, next_width):
        """Flush finished lanes' accumulators and stably compact the
        pending lanes into a next_width pool."""
        pending = pending_of(s)
        img.index_add_(0, s.pix, torch.where(pending[:, None], 0.0, s.accum))
        # flushed lanes may survive the cut when pending < next width:
        # zero their accumulators so nothing flushes twice
        s = s._replace(accum=torch.where(pending[:, None], s.accum, 0.0))
        order = torch.argsort((~pending).to(torch.int32), stable=True)
        return _take_lanes(s, order[:next_width]), img

    for stage, (width, p) in enumerate(zip(widths, plan)):
        last = stage == len(widths) - 1
        thresh = (pk_width if use_tailpk else 0) if last else widths[stage + 1]
        k_chain = p["k_chain"]
        kw = dict(
            spec_k=p["spec_k"], single_level=p["single_level"],
            bt=fine_bt if (p["tail"] and fine_bt is not None) else coarse_bt,
        )
        ctx = None
        if base_ctx is not None:  # every stage goes to the kernels
            ctx = fastbody.stage_context(
                base_ctx, kw["bt"], kw["single_level"],
                functools.partial(evaluate, **kw), spec_k=kw["spec_k"])
        rows_before = state.n_rows
        if ctx is not None:
            state, evals = fastbody.run_stage(ctx, state, thresh, k_chain,
                                              last)
            # the host's copy of n_rows, advanced by the stage's
            # evaluations in the kernels' float32 order
            rows_host = np.add.accumulate(np.concatenate([
                [rows_host], np.full(evals, width, np.float32)]),
                dtype=np.float32)[-1]
        else:
            while fastbody.pending_count(state, spp_per_lane) > thresh:
                for _ in range(k_chain):
                    state = step(state, **kw)
                fastbody.KERNEL.plain_evals += k_chain
        stage_rows.append(state.n_rows - rows_before)
        if last and not use_tailpk:
            img.index_add_(0, state.pix, state.accum)
        else:
            next_w = pk_width if last else widths[stage + 1]
            state, img = flush_compact(state, img, next_w)

    if use_tailpk:
        rows_before = state.n_rows
        state = _run_tailpk_stage(state, tail_context(
            scene, camera, settings, full_resolution, spp_per_lane, seed,
            path_id_of, pixel_xy_of, tail_pk_steps, base_ctx, eager_body))
        stage_rows.append(state.n_rows - rows_before)
        img.index_add_(0, state.pix, state.accum)

    img = img.reshape((n_tiles_batch, th, tw, 3) if multi_t else (th, tw, 3))
    if with_stats:
        if defer_ggx > 0 and float(state.n_rows) != float(rows_host):
            raise RuntimeError(
                f"fastSK: the host's n_rows {float(rows_host)} parted from "
                f"the device's {float(state.n_rows)}"
            )
        return (
            img, state.n_rays, state.n_rows, state.n_busy,
            torch.stack(stage_rows),
        )
    return img, state.n_rays


def stage_plan(widths, tail_width: int = _TAIL_CHAIN_WIDTH,
               spec_width: int = None, tail_spec: int = _TAIL_SPEC,
               tail_single_level: bool = False, two_level: bool = False,
               tail_chain: int = _TAIL_CHAIN):
    """Per cascade stage (pool width): whether it is a tail pool, the body
    evaluations chained per pending-count read, spec_k and single_level.
    Narrow tail pools chain several complete evaluations per read (extra
    evaluations past the exit are no-ops); pools up to spec_width may
    speculate and, with tail_single_level, switch to the global majorant
    (memoryless, so a mid-flight lane may restart under it); an (N, K)
    gather only pays while N*K is small, hence a width of its own."""
    plan = []
    for width in widths:
        tail = len(widths) > 1 and width <= tail_width
        narrow = len(widths) > 1 and width <= (
            tail_width if spec_width is None else spec_width)
        plan.append(dict(
            tail=tail, k_chain=tail_chain if tail else 1,
            spec_k=tail_spec if narrow else 1,
            single_level=narrow and tail_single_level and two_level,
        ))
    return plan


def tail_params(scene: Scene, settings: RenderSettings) -> torch.Tensor:
    """The tail kernel's (N_PARAMS,) float32 parameter vector."""
    med = scene.medium
    dev = scene.device
    nz, ny, nx = med.density.data.shape
    if _albedo_mode(scene) == "const":
        alb_a = torch.zeros(3, dtype=torch.float32, device=dev)
        alb_b = med.albedo.data.reshape(-1)[:3]
    else:
        alb_a, alb_b = med.albedo_affine[0], med.albedo_affine[1]
    tail = torch.tensor(
        [nx - 1, ny - 1, nz - 1, float(settings.max_path_length),
         1.0 if settings.russian_roulette else 0.0, nx, ny, nz],
        dtype=torch.float32, device=dev,
    )
    return torch.cat([
        torch.stack([med.scale, med.g]).to(torch.float32), alb_a, alb_b,
        med.box_min, med.box_max - med.box_min, tail,
    ]).contiguous()


@dataclasses.dataclass
class TailContext:
    """What a round of the tail stage reads besides the pool: the scene,
    camera and settings, the path-id layout, the tail kernel's dilated
    tables and parameter vector, the brick geometry, and fastbody's
    parameter vectors where render_tile built them (ops/taildrain packs
    the drain's from both)."""

    scene: Scene
    camera: cam.Camera
    settings: RenderSettings
    full_resolution: Tuple[int, int]
    spp_per_lane: int
    seed: object
    path_id_of: Callable
    pixel_xy_of: Callable
    pk_steps: int
    tables: tpk.TailTables
    params: torch.Tensor  # tail_params
    res_minus_1: torch.Tensor
    extent: torch.Tensor
    body: Optional[fastbody.BodyContext] = None
    eager_body: bool = False
    drain_params: Optional[tuple] = None  # ops/taildrain.params' cache


def tail_context(scene, camera, settings, full_resolution, spp_per_lane,
                 seed, path_id_of, pixel_xy_of, pk_steps, body=None,
                 eager_body=False) -> TailContext:
    """The tail stage's context: the dilated tables, the parameter vector
    and the brick geometry as the stage computes them."""
    med = scene.medium
    nz, ny, nx = med.density.data.shape
    return TailContext(
        scene=scene, camera=camera, settings=settings,
        full_resolution=full_resolution, spp_per_lane=spp_per_lane,
        seed=seed, path_id_of=path_id_of, pixel_xy_of=pixel_xy_of,
        pk_steps=pk_steps, tables=tpk.dilated_tail_bricks(med.density.data),
        params=tail_params(scene, settings),
        res_minus_1=torch.tensor([nx - 1, ny - 1, nz - 1],
                                 dtype=torch.float32, device=scene.device),
        extent=med.box_max - med.box_min, body=body, eager_body=eager_body,
    )


def plain_round(ctx: TailContext, s: FastState, exit_box: torch.Tensor,
                taps=None):
    """One round of the tail stage's eager loop on the pool `s`, mirroring
    body()'s event structure: regenerate finished lanes (camera rays),
    classify AABB entries and misses, apply boundary events (a kernel
    EXIT_BOX or a fresh outside hit: boundary_event, bounce + 1, the cap,
    Russian roulette), refresh each tracking lane's brick window, then hand
    the pool to the tail kernel for pk_steps tracking steps in which
    scatters, RR and the path cap are handled without leaving it.
    Mid-flight lanes restart under the window majorant (memoryless — the
    piecewise-majorant argument).  Returns (s', exit_box', the lanes that
    started a segment, the lanes that tracked): s' counts them into n_rays
    and n_busy, and n_rows + the pool's width.  A list given as `taps`
    receives the round's per-lane traffic and table reads
    (ops/taildrain.drain_bytes); the steps then run the tail kernel's plain
    version."""
    scene, settings = ctx.scene, ctx.settings
    med = scene.medium
    R = s.alive.shape[0]
    o, d, tput, accum, normal = s.o, s.d, s.throughput, s.accum, s.normal
    t, max_t, samples_done, bounce = s.t, s.max_t, s.samples_done, s.bounce
    alive, tracking, rng = s.alive, s.tracking, s.rng

    # --- regenerate (body()'s regen block at (R,) width) -------------------
    needs = ~alive & (samples_done < ctx.spp_per_lane)
    fresh = make_rng(ctx.seed, ctx.path_id_of(s.pix, s.slot, samples_done))
    rng = RngState(
        state=torch.where(needs, fresh.state, rng.state),
        inc=torch.where(needs, fresh.inc, rng.inc),
    )
    o_new, d_new, rng = cam.generate_rays(
        ctx.camera, ctx.pixel_xy_of(s.pix), ctx.full_resolution, rng,
        active=needs,
    )
    mm = needs[:, None]
    o = torch.where(mm, o_new, o)
    d = torch.where(mm, d_new, d)
    tput = torch.where(mm, 1.0, tput)
    alive = alive | needs
    tracking = tracking & ~needs
    exit_box = exit_box & ~needs
    bounce = torch.where(needs, 0, bounce)

    # --- AABB entry / miss service -----------------------------------------
    need_isect = alive & ~tracking & ~exit_box
    n_rays = s.n_rays + need_isect.to(torch.float32).sum()
    isect = aabb.aabb_intersect(med.box_min, med.box_max, o, d)
    miss = need_isect & ~isect.hit
    accum = torch.where(miss[:, None], accum + tput * scene.le, accum)
    samples_done = torch.where(miss, samples_done + 1, samples_done)
    alive = alive & ~miss
    enters = need_isect & isect.hit & isect.inside_volume
    boundary_now = need_isect & isect.hit & ~isect.inside_volume
    tracking = tracking | enters
    t = torch.where(enters, 0.0, t)
    max_t = torch.where(enters, isect.dist, max_t)
    normal = torch.where(need_isect[:, None], isect.normal, normal)

    # --- boundary events (kernel EXIT_BOX + fresh outside hits) ------------
    bmask = exit_box | boundary_now
    o_bound = torch.where(
        boundary_now[:, None],
        o + d * isect.dist[:, None],
        o + d * max_t[:, None],
    )
    o_b, d_b, t_b, rng = integrator.boundary_event(
        scene, settings, normal, o_bound, d, tput, rng, bmask
    )
    bm = bmask[:, None]
    o = torch.where(bm, o_b, o)
    d = torch.where(bm, d_b, d)
    tput = torch.where(bm, t_b, tput)
    bounce = torch.where(bmask, bounce + 1, bounce)
    capped = bmask & (bounce >= settings.max_path_length)
    alive = alive & ~capped
    samples_done = torch.where(capped, samples_done + 1, samples_done)
    if settings.russian_roulette:
        tput, alive, killed, rng = integrator.russian_roulette(
            tput, alive, rng, bmask & ~capped
        )
        samples_done = torch.where(killed, samples_done + 1, samples_done)

    # --- window refresh for tracking lanes ---------------------------------
    track = tracking
    tables = ctx.tables
    bflat, worg, inv_sig, rho_b, bexit = tpk.brick_window(
        o, d, t, med.box_min, ctx.extent, ctx.res_minus_1, tables.dims,
        tables.major, med.scale,
    )

    # --- kernel: pk_steps tracking steps -----------------------------------
    f_in = torch.stack([
        *o.T, *d.T, *tput.T, t, max_t, bexit, inv_sig, rho_b, *normal.T,
    ])
    i_in = torch.cat([
        worg.T, torch.stack([bounce, torch.where(track, tpk.RUN, tpk.DEAD)]),
    ]).to(torch.int32)
    args = (tables.tab, torch.where(track, bflat, 0), ctx.params, f_in, i_in,
            torch.stack([rng.state, rng.inc]), ctx.pk_steps)
    if taps is None:
        f_out, i_out, rng_state = tpk.run_tail_steps(*args)
    else:
        steps = []
        f_out, i_out, rng_state = tpk.tail_steps(*args, taps=steps)
        taps += [("tab", x) for x in steps]
        taps.append(("major", bflat[track]))
    tr3 = track[:, None]
    o = torch.where(tr3, f_out[tpk.F_OX:tpk.F_OZ + 1].T, o)
    d = torch.where(tr3, f_out[tpk.F_DX:tpk.F_DZ + 1].T, d)
    tput = torch.where(tr3, f_out[tpk.F_TR:tpk.F_TB + 1].T, tput)
    normal = torch.where(tr3, f_out[tpk.F_NX:tpk.F_NZ + 1].T, normal)
    t = torch.where(track, f_out[tpk.F_T], t)
    max_t = torch.where(track, f_out[tpk.F_MAXT], max_t)
    bounce = torch.where(track, i_out[0].to(torch.int64), bounce)
    rng = RngState(state=torch.where(track, rng_state, rng.state),
                   inc=rng.inc)
    status = i_out[1]
    died = track & (status == tpk.DEAD)
    alive = alive & ~died
    samples_done = torch.where(died, samples_done + 1, samples_done)
    exit_box_out = track & (status == tpk.EXIT_BOX)
    tracking = track & ((status == tpk.RUN) | (status == tpk.NEED_WINDOW))

    new = s._replace(
        o=o, d=d, throughput=tput, accum=accum, normal=normal, t=t,
        max_t=max_t, samples_done=samples_done, bounce=bounce, alive=alive,
        tracking=tracking, rng=rng, n_rays=n_rays, n_rows=s.n_rows + float(R),
        n_busy=s.n_busy + track.to(torch.float32).sum(),
    )
    if taps is not None:
        # the lanes whose round reads each field before it writes it (a
        # regenerated lane writes its path's fields unread)
        live = s.alive
        ran = s.alive | (s.samples_done < ctx.spp_per_lane)
        reads = {
            "alive": torch.ones_like(live), "samples_done": torch.ones_like(
                live), "tracking": live, "pix": needs, "slot": needs,
            "o": live, "d": live, "throughput": live, "normal": live,
            "bounce": live, "accum": miss,
            "t": live & (s.tracking | exit_box), "max_t": live & (
                s.tracking | exit_box),
        }
        taps.append(("state", stages.lane_traffic(
            s, new, reads, tuple(taildrain.FIELD_BYTES))))
        taps.append(("round", ran))
    return new, exit_box_out, need_isect, track


def plain_stage(ctx: TailContext, state: FastState, taps=None) -> FastState:
    """The tail stage's eager loop: plain_round while a lane is pending,
    the pending count read to the host each round (counted in
    taildrain.KERNEL.reads, the rounds in plain_rounds)."""
    s = state
    exit_box = torch.zeros_like(s.alive)
    while True:
        taildrain.KERNEL.reads += 1
        if not int(torch.count_nonzero(
                s.alive | (s.samples_done < ctx.spp_per_lane))):
            return s
        s, exit_box, _, _ = plain_round(ctx, s, exit_box, taps)
        taildrain.KERNEL.plain_rounds += 1


def _run_tailpk_stage(state: FastState, ctx: TailContext) -> FastState:
    """The tail stage around the persistent tail kernel: on the card one
    drain launch (ops/taildrain.py, csrc/tailpk.cu's drain_kernel), else
    (the CPU, or eager_body=True) its plain version, plain_stage."""
    if taildrain.route(state.alive.device.type, ctx.eager_body):
        return taildrain.run_stage(ctx, state)
    return plain_stage(ctx, state)
