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

Port notes: the lax.while_loop is a Python loop that reads its condition
on the host once per round; the packed bitcast matrix that permuted the
state in one XLA gather becomes one index_select per field; the kernel
reads the shared (NB, 256) table at each row's brick index, so a round
gathers no table copy; the final scatter-add by pixel is index_add_.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..constants import EPSILON
from ..ops import aabb, camera as cam, phase
from ..ops import tracking as tk
from ..ops.rng import M32, RngState, make_rng, next_uint32
from ..scene.types import RenderSettings, Scene
from . import integrator
from .fast import (
    _stochastic_tap, _take_lanes, fused_row_decode, make_fused_grid,
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
):
    """Render spp samples of every pixel of one tile.  Returns
    (img (th, tw, 3), n_rays), and with with_stats also the number of
    rounds (one kernel call each)."""
    dev = scene.device
    tile_offset = torch.as_tensor(tile_offset, dtype=torch.float32, device=dev)
    tw, th = tile_dim
    n_pix = tw * th
    m = lanes_per_pixel
    while spp % m != 0:
        m -= 1
    spp_per_lane = spp // m
    n_lanes = n_pix * m
    if n_lanes % 128 != 0:
        raise ValueError("brickSK needs lane count divisible by 128")
    n_rows = n_lanes // 128
    med = scene.medium

    fused = make_fused_grid(scene)
    tables, brick_major = tk.build_dilated_bricks(med.density.data)
    tables = tables.reshape(-1, tk.ROW)
    nbz, nby, nbx = brick_major.shape
    n_bricks = nbz * nby * nbx
    bm_flat = brick_major.reshape(-1)
    nz, ny, nx = med.density.data.shape
    res_minus_1 = torch.tensor(
        [nx - 1, ny - 1, nz - 1], dtype=torch.float32, device=dev
    )
    extent = med.box_max - med.box_min
    scale = med.scale
    bz_, by_, bx_ = tk.BRICK
    brick_size = torch.tensor([bx_, by_, bz_], dtype=torch.float32, device=dev)
    brick_hi = torch.tensor([nbx - 1, nby - 1, nbz - 1], device=dev)

    lane = torch.arange(n_lanes, dtype=torch.int64, device=dev)
    # the slot belongs to the lane position, as in the JAX package (after
    # a sort it need not be the slot the lane's pixel started in)
    slot = lane // n_pix
    base_id = int(path_id_base) & M32

    def pixel_xy_of(pix):
        px = (pix % tw).to(torch.float32) + tile_offset[0]
        py = torch.floor(pix.to(torch.float32) / tw) + tile_offset[1]
        return torch.stack([px, py], dim=-1)

    def path_id_of(pix, samples_done):
        s = slot + m * samples_done
        return (s * n_pix + pix + base_id) & M32

    def brick_of(p):
        """Brick (x, y, z) index and flat id of world points p (N, 3)."""
        coordn = (
            torch.clamp((p - med.box_min) / extent, 0.0, 1.0) * res_minus_1
        )
        bi = torch.minimum(
            torch.clamp(torch.floor(coordn / brick_size).to(torch.int64), min=0),
            brick_hi,
        )
        return bi, (bi[:, 2] * nby + bi[:, 1]) * nbx + bi[:, 0]

    def zeros(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=dev)

    state = BrickState(
        o=zeros(n_lanes, 3),
        d=torch.tensor([0.0, 0.0, 1.0], device=dev).repeat(n_lanes, 1),
        throughput=torch.ones((n_lanes, 3), device=dev),
        accum=zeros(n_lanes, 3), normal=zeros(n_lanes, 3),
        base=zeros(n_lanes, 3),
        t=zeros(n_lanes), max_t=zeros(n_lanes),
        brick_exit=torch.full((n_lanes,), -1.0, device=dev),
        inv_sig=zeros(n_lanes),
        pix=lane % n_pix,
        samples_done=zeros(n_lanes, dtype=torch.int64),
        status=torch.full((n_lanes,), MASKED, device=dev),
        alive=zeros(n_lanes, dtype=torch.bool),
        tracking=zeros(n_lanes, dtype=torch.bool),
        rng=make_rng(seed, zeros(n_lanes, dtype=torch.int64)),
        n_rays=zeros(),
    )

    def phase_a(s: BrickState) -> BrickState:
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
            torch.clamp((p_scat - med.box_min) / extent, 0.0, 1.0)
            * res_minus_1
        )
        tap_bits, rng = next_uint32(rng, scattered)
        tap = _stochastic_tap(coord, tap_bits)
        ix = torch.clamp(tap[:, 0], 0, nx - 1)
        iy = torch.clamp(tap[:, 1], 0, ny - 1)
        iz = torch.clamp(tap[:, 2], 0, nz - 1)
        alb_hat = fused_row_decode(scene, fused[(iz * ny + iy) * nx + ix])[1]
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
        needs = ~alive & (samples_done < spp_per_lane)
        fresh = make_rng(seed, path_id_of(s.pix, samples_done))
        rng = RngState(
            state=torch.where(needs, fresh.state, rng.state),
            inc=torch.where(needs, fresh.inc, rng.inc),
        )
        o_new, d_new, rng = cam.generate_rays(
            camera, pixel_xy_of(s.pix), full_resolution, rng, active=needs
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
        epsw = torch.amax(extent) * 1e-6
        for _ in range(3):
            needb = tracking & (t >= brick_exit)
            bi, bflat = brick_of(o + (t + epsw)[:, None] * d)
            rho_b = bm_flat[bflat]
            up = (d > 0.0).to(torch.float32)
            bound_coord = (bi.to(torch.float32) + up) * brick_size
            bound_world = med.box_min + extent * bound_coord / res_minus_1
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
                needb[:, None], bi.to(torch.float32) * brick_size, base
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
        return BrickState(
            o=o, d=d, throughput=tput, accum=accum, normal=normal,
            base=base, t=t, max_t=max_t, brick_exit=brick_exit,
            inv_sig=inv_sig, pix=s.pix, samples_done=samples_done,
            status=status, alive=alive, tracking=tracking | pend, rng=rng,
            n_rays=n_rays,
        )

    def kernel_round(s: BrickState) -> BrickState:
        # lanes eligible for the kernel: tracking with a finite majorant
        # and no pending boundary event
        eligible = s.tracking & torch.isfinite(s.inv_sig) & (s.status == MASKED)
        _, bflat = brick_of(s.o + (s.t + 1e-6)[:, None] * s.d)
        keys = torch.where(eligible, bflat, _SENTINEL)
        order = torch.argsort(keys, stable=True)
        ss = _take_lanes(s, order)

        key_rows = keys[order].reshape(n_rows, 128)
        row_key = key_rows[:, 0]
        usable = (key_rows == row_key[:, None]) & (row_key != _SENTINEL)[:, None]
        row_brick = torch.clamp(row_key, max=n_bricks - 1).contiguous()

        # rays in voxel-coordinate space (the kernel is geometry-free)
        vox_scale = res_minus_1 / extent
        o_vox = (ss.o - med.box_min) * vox_scale
        d_vox = ss.d * vox_scale
        inv_sig_safe = torch.where(torch.isfinite(ss.inv_sig), ss.inv_sig, 0.0)
        f = torch.cat([
            o_vox.T, d_vox.T, torch.stack([ss.t, ss.max_t, ss.brick_exit]),
            ss.base.T, torch.stack([inv_sig_safe, inv_sig_safe * scale]),
        ]).reshape(tk.N_F, n_rows, 128)
        rng_in = torch.stack([ss.rng.state, ss.rng.inc]).reshape(2, n_rows, 128)
        status_in = torch.where(usable, tk.RUNNING, MASKED).to(torch.int32)
        t_out, st_out, _tap, rng_out = tk.run_track_steps(
            tables, row_brick, f, rng_in, status_in, k_steps
        )
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

    rounds = 0
    while bool(torch.any(state.alive | (state.samples_done < spp_per_lane))):
        state = kernel_round(phase_a(state))
        rounds += 1

    # lanes are in arbitrary (sorted) order: scatter-add once at the end
    img = torch.zeros((n_pix, 3), dtype=torch.float32, device=dev)
    img.index_add_(0, state.pix, state.accum)
    img = img.reshape(th, tw, 3)
    if with_stats:
        return img, state.n_rays, rounds
    return img, state.n_rays
