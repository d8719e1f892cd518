"""brickSK: the sorted brick-wavefront scheduler (port of
cudavolumerenderer_tpu/models/brick.py) around the tracking kernel
(ops/tracking.py, csrc/tracking.cu).

Each round:
  phase A (torch ops): consume kernel statuses — scatter events
     (stochastic albedo tap from the fused grid, HG), boundary events
     (GGX), Russian roulette, regeneration of finished lanes (lane-pinned
     pixels), AABB for new segments, and three DDA brick steps for every
     tracking lane (empty bricks are leapt here);
  sort: keys = brick id (lanes that cannot track keyed to the end), one
     stable argsort, and the state permuted with it;
  kernel: rows whose lanes match the row's leading brick run K steps;
     stragglers in boundary rows are masked and retry next round.

Per-lane RNG streams are the same (seed, path_id) PCG streams as every
other scheduler.  A lane's path does not depend on its row (a lane that
sits out keeps its state), so the image does not depend on the
permutation; the stable sort keeps the JAX package's permutation anyway,
and with it the round count.

Port notes: on the card the rounds run through ops/brickbody.py
(csrc/brickbody.cu: phase A in one launch, torch's stable sort, the
tracking round in one launch; the lanes stay in place and carry their
sorted position; rounds enqueued in gated batches with one host read per
batch).  The functions below are its plain versions, and the eager loop
(`eager_body=True`, and the CPU) runs them as JAX's loop did: a Python
loop that reads its condition on the host once per round; the packed
bitcast matrix that permuted the state in one XLA gather becomes one
index_select per field; the tracking kernel reads the shared (NB, 256)
table at each row's brick index, so a round gathers no table copy; the
final scatter-add by pixel is index_add_.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import torch

from ..constants import EPSILON
from ..ops import aabb, brickbody, camera as cam, phase
from ..ops import tracking as tk
from ..ops.rng import M32, RngState, make_rng, next_uint32
from ..scene.types import RenderSettings, Scene
from . import integrator
from .fast import (
    _albedo_mode, _stochastic_tap, _take_lanes, fused_row_decode,
    make_fused_grid,
)

MASKED = 4  # extra status: lane sat out the kernel round
_SENTINEL = 0xFFFFFFFF  # sort key of lanes that cannot track this round


class BrickState(NamedTuple):
    o: torch.Tensor  # (N, 3)
    d: torch.Tensor
    throughput: torch.Tensor
    accum: torch.Tensor
    normal: torch.Tensor
    t: torch.Tensor
    max_t: torch.Tensor
    brick_exit: torch.Tensor
    inv_sig: torch.Tensor
    base: torch.Tensor  # (N, 3) dilated-table base voxel coords (float)
    pix: torch.Tensor  # (N,) int64
    samples_done: torch.Tensor  # (N,) int64
    status: torch.Tensor  # (N,) int64 kernel status codes
    alive: torch.Tensor
    tracking: torch.Tensor
    rng: RngState
    n_rays: torch.Tensor  # () f32


@dataclasses.dataclass
class BrickContext:
    """What one render_tile call computes before its rounds: the tile and
    the sample split, the scene's tables (the fused grid, the dilated brick
    tables and their majorants) and the geometry the phase-A ops read.  The
    plain versions and csrc/brickbody.cu's parameters both read it."""

    scene: Scene
    camera: cam.Camera
    settings: RenderSettings
    tile_dim: Tuple[int, int]
    tile_offset: torch.Tensor  # (2,) f32
    full_resolution: Tuple[int, int]
    seed: object
    base_id: int  # path_id_base as a uint32
    m: int  # lanes per pixel
    spp_per_lane: int
    n_pix: int
    n_lanes: int
    n_rows: int
    k_steps: int
    albedo_mode: str  # 'const', 'affine' or 'full'
    fused: torch.Tensor  # make_fused_grid
    tables: torch.Tensor  # (NB, 256) dilated brick tables
    bm_flat: torch.Tensor  # (NB,) dilated majorants
    n_bricks_zyx: Tuple[int, int, int]
    res_minus_1: torch.Tensor  # (3,) f32, x y z
    extent: torch.Tensor
    brick_size: torch.Tensor
    brick_hi: torch.Tensor  # (3,) int64
    epsw: torch.Tensor  # () f32
    slot: torch.Tensor  # (N,) int64: a sorted position's slot
    _params: object = None  # brickbody's kernel parameters, built once

    @property
    def n_bricks(self) -> int:
        nbz, nby, nbx = self.n_bricks_zyx
        return nbz * nby * nbx


def make_context(scene: Scene, camera, settings: RenderSettings, tile_dim,
                 tile_offset, full_resolution, spp: int, seed, path_id_base,
                 lanes_per_pixel: int = 1, k_steps: int = 8) -> BrickContext:
    dev = scene.device
    tw, th = tile_dim
    n_pix = tw * th
    m = lanes_per_pixel
    while spp % m != 0:
        m -= 1
    n_lanes = n_pix * m
    if n_lanes % 128 != 0:
        raise ValueError("brickSK needs lane count divisible by 128")
    med = scene.medium
    tables, brick_major = tk.build_dilated_bricks(med.density.data)
    nbz, nby, nbx = brick_major.shape
    nz, ny, nx = med.density.data.shape
    bz_, by_, bx_ = tk.BRICK
    extent = med.box_max - med.box_min
    return BrickContext(
        scene=scene, camera=camera, settings=settings, tile_dim=(tw, th),
        tile_offset=torch.as_tensor(tile_offset, dtype=torch.float32,
                                    device=dev),
        full_resolution=tuple(full_resolution), seed=seed,
        base_id=int(path_id_base) & M32, m=m, spp_per_lane=spp // m,
        n_pix=n_pix, n_lanes=n_lanes, n_rows=n_lanes // 128,
        k_steps=k_steps, albedo_mode=_albedo_mode(scene),
        fused=make_fused_grid(scene), tables=tables.reshape(-1, tk.ROW),
        bm_flat=brick_major.reshape(-1), n_bricks_zyx=(nbz, nby, nbx),
        res_minus_1=torch.tensor([nx - 1, ny - 1, nz - 1],
                                 dtype=torch.float32, device=dev),
        extent=extent,
        brick_size=torch.tensor([bx_, by_, bz_], dtype=torch.float32,
                                device=dev),
        brick_hi=torch.tensor([nbx - 1, nby - 1, nbz - 1], device=dev),
        epsw=torch.amax(extent) * 1e-6,
        slot=torch.arange(n_lanes, dtype=torch.int64, device=dev) // n_pix,
    )


def initial_state(ctx: BrickContext) -> BrickState:
    """Every lane finished with samples left: the first phase A starts
    each lane's first path."""
    dev = ctx.scene.device
    n = ctx.n_lanes

    def zeros(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=dev)

    return BrickState(
        o=zeros(n, 3),
        d=torch.tensor([0.0, 0.0, 1.0], device=dev).repeat(n, 1),
        throughput=torch.ones((n, 3), device=dev),
        accum=zeros(n, 3), normal=zeros(n, 3), base=zeros(n, 3),
        t=zeros(n), max_t=zeros(n),
        brick_exit=torch.full((n,), -1.0, device=dev),
        inv_sig=zeros(n),
        pix=torch.arange(n, dtype=torch.int64, device=dev) % ctx.n_pix,
        samples_done=zeros(n, dtype=torch.int64),
        status=torch.full((n,), MASKED, device=dev),
        alive=zeros(n, dtype=torch.bool),
        tracking=zeros(n, dtype=torch.bool),
        rng=make_rng(ctx.seed, zeros(n, dtype=torch.int64)),
        n_rays=zeros(),
    )


def pending_count(ctx: BrickContext, s: BrickState) -> torch.Tensor:
    """The loop's count: lanes alive or with samples left (0-d int64)."""
    return torch.count_nonzero(s.alive | (s.samples_done < ctx.spp_per_lane))


def _brick_of(ctx: BrickContext, p):
    """Brick (x, y, z) index and flat id of world points p (N, 3)."""
    med = ctx.scene.medium
    nbz, nby, nbx = ctx.n_bricks_zyx
    coordn = (
        torch.clamp((p - med.box_min) / ctx.extent, 0.0, 1.0) * ctx.res_minus_1
    )
    bi = torch.minimum(
        torch.clamp(torch.floor(coordn / ctx.brick_size).to(torch.int64), min=0),
        ctx.brick_hi,
    )
    return bi, (bi[:, 2] * nby + bi[:, 1]) * nbx + bi[:, 0]


def phase_a(ctx: BrickContext, s: BrickState, taps=None) -> BrickState:
    """Phase A of every lane of a position-ordered state (a lane's slot is
    its position's).  A list given as `taps` receives ("fused", flat
    indices) of the scatters' albedo taps (where the albedo is read from
    the grid), ("major", flat brick ids) of the DDA's majorant reads and
    ("lanes", the masks of the lanes that start a path, miss the box or
    take a boundary event), for ops/brickbody.brick_bytes."""
    scene, settings, med = ctx.scene, ctx.settings, ctx.scene.medium
    nz, ny, nx = med.density.data.shape
    tw = ctx.tile_dim[0]
    o, d, tput, accum = s.o, s.d, s.throughput, s.accum
    alive, rng, samples_done = s.alive, s.rng, s.samples_done

    # ---- consume kernel statuses ----------------------------------
    scattered = s.tracking & (s.status == tk.SCATTER)
    exited_box = s.tracking & (s.status == tk.EXIT_BOX)
    exited_brick = s.tracking & (s.status == tk.EXIT_BRICK)

    # brick-exit lanes resume from the brick boundary
    t = torch.where(exited_brick, s.brick_exit, s.t)
    brick_exit = torch.where(exited_brick, -1.0, s.brick_exit)
    tracking = s.tracking & ~(scattered | exited_box)

    # ---- scatter event: stochastic albedo tap + HG ------------------
    p_scat = o + t[:, None] * d - d * EPSILON
    coord = (
        torch.clamp((p_scat - med.box_min) / ctx.extent, 0.0, 1.0)
        * ctx.res_minus_1
    )
    tap_bits, rng = next_uint32(rng, scattered)
    tap = _stochastic_tap(coord, tap_bits)
    ix = torch.clamp(tap[:, 0], 0, nx - 1)
    iy = torch.clamp(tap[:, 1], 0, ny - 1)
    iz = torch.clamp(tap[:, 2], 0, nz - 1)
    flat = (iz * ny + iy) * nx + ix
    if taps is not None and ctx.albedo_mode != "const":
        taps.append(("fused", flat[scattered]))
    alb_hat = fused_row_decode(scene, ctx.fused[flat])[1]
    d_scat, rng = phase.sample_phase(d, med.g, rng, active=scattered)
    sc = scattered[:, None]
    o = torch.where(sc, p_scat, o)
    d = torch.where(sc, d_scat, d)
    tput = torch.where(sc, tput * alb_hat, tput)

    # ---- boundary event (GGX or null) -------------------------------
    o_bound = o + d * s.max_t[:, None]
    o_b, d, tput, rng = integrator.boundary_event(
        scene, settings, s.normal, o_bound, d, tput, rng, exited_box
    )
    o = torch.where(exited_box[:, None], o_b, o)

    # ---- Russian roulette -------------------------------------------
    if settings.russian_roulette:
        tput, alive, killed, rng = integrator.russian_roulette(
            tput, alive, rng, scattered | exited_box
        )
        samples_done = torch.where(killed, samples_done + 1, samples_done)

    # ---- regeneration (lane-pinned pixel, next sample) --------------
    # the slot belongs to the lane position, as in the JAX package (after
    # a sort it need not be the slot the lane's pixel started in)
    needs = ~alive & (samples_done < ctx.spp_per_lane)
    sid = ctx.slot + ctx.m * samples_done
    fresh = make_rng(ctx.seed, (sid * ctx.n_pix + s.pix + ctx.base_id) & M32)
    rng = RngState(
        state=torch.where(needs, fresh.state, rng.state),
        inc=torch.where(needs, fresh.inc, rng.inc),
    )
    px = (s.pix % tw).to(torch.float32) + ctx.tile_offset[0]
    py = torch.floor(s.pix.to(torch.float32) / tw) + ctx.tile_offset[1]
    o_new, d_new, rng = cam.generate_rays(
        ctx.camera, torch.stack([px, py], dim=-1), ctx.full_resolution, rng,
        active=needs,
    )
    mm = needs[:, None]
    o = torch.where(mm, o_new, o)
    d = torch.where(mm, d_new, d)
    tput = torch.where(mm, 1.0, tput)
    alive = alive | needs
    tracking = tracking & ~needs

    # ---- AABB for all segment starts --------------------------------
    need_isect = alive & ~tracking
    n_rays = s.n_rays + need_isect.to(torch.float32).sum()
    isect = aabb.aabb_intersect(med.box_min, med.box_max, o, d)
    miss = need_isect & ~isect.hit
    accum = torch.where(miss[:, None], accum + tput * scene.le, accum)
    samples_done = torch.where(miss, samples_done + 1, samples_done)
    alive = alive & ~miss
    enters = need_isect & isect.hit & isect.inside_volume
    # outside-hit lanes jump to the surface and take the boundary
    # event next phase A (flagged by EXIT_BOX status + cached normal)
    boundary_now = need_isect & isect.hit & ~isect.inside_volume
    tracking = tracking | enters
    t = torch.where(enters, 0.0, t)
    max_t = torch.where(enters | boundary_now, isect.dist, s.max_t)
    normal = torch.where(need_isect[:, None], isect.normal, s.normal)
    brick_exit = torch.where(enters, -1.0, brick_exit)

    # ---- DDA brick assignment / empty-brick leap --------------------
    # three steps, so up to three empty bricks are crossed per phase A
    inv_sig, base = s.inv_sig, s.base
    pend_exitbox = torch.zeros_like(tracking)
    epsw = ctx.epsw
    scale = med.scale
    for _ in range(3):
        needb = tracking & (t >= brick_exit)
        bi, bflat = _brick_of(ctx, o + (t + epsw)[:, None] * d)
        rho_b = ctx.bm_flat[bflat]
        if taps is not None:
            taps.append(("major", bflat[needb]))
        up = (d > 0.0).to(torch.float32)
        bound_coord = (bi.to(torch.float32) + up) * ctx.brick_size
        bound_world = med.box_min + ctx.extent * bound_coord / ctx.res_minus_1
        okd = torch.abs(d) > 1e-12
        t_axes = torch.where(
            okd, (bound_world - o) / torch.where(okd, d, 1.0), torch.inf
        )
        exit_new = torch.maximum(torch.amin(t_axes, dim=-1), t + epsw)
        brick_exit = torch.where(needb, exit_new, brick_exit)
        inv_new = torch.where(
            rho_b > 0.0,
            1.0 / (scale * torch.clamp(rho_b, min=1e-30)),
            torch.inf,
        )
        inv_sig = torch.where(needb, inv_new, inv_sig)
        base = torch.where(
            needb[:, None], bi.to(torch.float32) * ctx.brick_size, base
        )
        # leap empty bricks now
        empty = tracking & ~torch.isfinite(inv_sig)
        hits_box = empty & (brick_exit >= max_t)
        t = torch.where(empty, torch.minimum(brick_exit, max_t), t)
        pend_exitbox = pend_exitbox | hits_box
        tracking = tracking & ~hits_box

    # lanes that leapt to the medium exit, and fresh outside hits, take
    # the boundary event next phase A: flag them EXIT_BOX and tracking
    pend = pend_exitbox | boundary_now
    status = torch.where(pend, tk.EXIT_BOX, MASKED)
    if taps is not None:
        taps.append(("lanes", {"needs": needs, "miss": miss,
                               "exited_box": exited_box}))
    return BrickState(
        o=o, d=d, throughput=tput, accum=accum, normal=normal,
        base=base, t=t, max_t=max_t, brick_exit=brick_exit,
        inv_sig=inv_sig, pix=s.pix, samples_done=samples_done,
        status=status, alive=alive, tracking=tracking | pend, rng=rng,
        n_rays=n_rays,
    )


def round_keys(ctx: BrickContext, s: BrickState) -> torch.Tensor:
    """Each lane's sort key: the brick at o + (t + 1e-6) d for lanes
    eligible for the kernel (tracking with a finite majorant and no
    pending boundary event), else the sentinel."""
    eligible = s.tracking & torch.isfinite(s.inv_sig) & (s.status == MASKED)
    _, bflat = _brick_of(ctx, s.o + (s.t + 1e-6)[:, None] * s.d)
    return torch.where(eligible, bflat, _SENTINEL)


def track_rows(ctx: BrickContext, ss: BrickState, sorted_keys: torch.Tensor,
               sentinel: int = _SENTINEL, taps=None) -> BrickState:
    """The tracking round of a sorted state whose keys are `sorted_keys`:
    each row of 128 positions runs K steps of the tracking kernel in its
    leading key's brick for the lanes whose key is that key (the usable
    lanes); the rest sit out.  A list given as `taps` receives ("table",
    flat table words) of the steps' taps."""
    med = ctx.scene.medium
    key_rows = sorted_keys.reshape(ctx.n_rows, 128)
    row_key = key_rows[:, 0]
    usable = (key_rows == row_key[:, None]) & (row_key != sentinel)[:, None]
    row_brick = torch.clamp(row_key, max=ctx.n_bricks - 1).to(
        torch.int64).contiguous()

    # rays in voxel-coordinate space (the kernel is geometry-free)
    vox_scale = ctx.res_minus_1 / ctx.extent
    o_vox = (ss.o - med.box_min) * vox_scale
    d_vox = ss.d * vox_scale
    inv_sig_safe = torch.where(torch.isfinite(ss.inv_sig), ss.inv_sig, 0.0)
    f = torch.cat([
        o_vox.T, d_vox.T, torch.stack([ss.t, ss.max_t, ss.brick_exit]),
        ss.base.T, torch.stack([inv_sig_safe, inv_sig_safe * med.scale]),
    ]).reshape(tk.N_F, ctx.n_rows, 128)
    rng_in = torch.stack([ss.rng.state, ss.rng.inc]).reshape(
        2, ctx.n_rows, 128)
    status_in = torch.where(usable, tk.RUNNING, MASKED).to(torch.int32)
    if taps is None:
        t_out, st_out, _tap, rng_out = tk.run_track_steps(
            ctx.tables, row_brick, f, rng_in, status_in, ctx.k_steps
        )
    else:
        words = []
        t_out, st_out, _tap, rng_out = tk.track_steps(
            ctx.tables, row_brick, f, rng_in, status_in, ctx.k_steps,
            taps=words)
        taps.append(("table", torch.cat(words)))
    u = usable.reshape(-1)
    st_out = st_out.reshape(-1).to(torch.int64)
    # kernel lanes still RUNNING at round end are masked for the next
    # phase A (no event)
    status = torch.where(
        u, torch.where(st_out == tk.RUNNING, MASKED, st_out), ss.status
    )
    return ss._replace(
        t=torch.where(u, t_out.reshape(-1), ss.t),
        status=status,
        rng=RngState(
            state=torch.where(u, rng_out.reshape(-1), ss.rng.state),
            inc=ss.rng.inc,
        ),
    )


def kernel_round(ctx: BrickContext, s: BrickState) -> BrickState:
    """The sort and the tracking round: keys, one stable argsort, the
    state permuted with it, K steps in each row."""
    keys = round_keys(ctx, s)
    order = torch.argsort(keys, stable=True)
    return track_rows(ctx, _take_lanes(s, order), keys[order])


def eager_loop(ctx: BrickContext, state: BrickState):
    """The rounds as the JAX package's loop runs them, one host read of
    the condition per round (counted in brickbody.KERNEL.reads): (final
    state in sorted order, rounds)."""
    rounds = 0
    while True:
        brickbody.KERNEL.reads += 1
        if not bool(pending_count(ctx, state)):
            return state, rounds
        state = kernel_round(ctx, phase_a(ctx, state))
        rounds += 1


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
    k_steps: int = 8,
    with_stats: bool = False,
    eager_body: bool = False,
):
    """Render spp samples of every pixel of one tile.  Returns
    (img (th, tw, 3), n_rays), and with with_stats also the number of
    rounds.  On the card the rounds run through csrc/brickbody.cu
    (ops/brickbody.run_rounds) unless eager_body; the CPU and eager_body
    run the eager loop (one tracking-kernel call per round on the card)."""
    ctx = make_context(scene, camera, settings, tile_dim, tile_offset,
                       full_resolution, spp, seed, path_id_base,
                       lanes_per_pixel, k_steps)
    state = initial_state(ctx)
    if brickbody.route(scene.device.type, eager_body):
        state, pos, rounds = brickbody.run_rounds(ctx, state, kernel=True)
        # the lanes in their sorted order, as the eager loop leaves them
        state = _take_lanes(state, brickbody.perm_of(pos))
    else:
        state, rounds = eager_loop(ctx, state)

    # lanes are in arbitrary (sorted) order: scatter-add once at the end
    tw, th = ctx.tile_dim
    img = torch.zeros((ctx.n_pix, 3), dtype=torch.float32, device=scene.device)
    img.index_add_(0, state.pix, state.accum)
    img = img.reshape(th, tw, 3)
    if with_stats:
        return img, state.n_rays, rounds
    return img, state.n_rays
