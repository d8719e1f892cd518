"""Differentiable rendering: gradients of pixel radiance with respect to
the voxel density and albedo grids, through the stochastic transmittance
estimator (port of cudavolumerenderer_tpu/models/differentiable.py).

Path-replay backprop with a score-function density estimator:

  forward:   render as usual; the two-level forward also keeps each
             lane's radiance C (pass-A elision).
  backward:  replay every path with the identical counter-based RNG
             streams (ops/rng.py) — pass A recomputes each lane's
             contribution C (one-level only), pass B replays again and
             scatter-adds adjoints:
               albedo (reparameterised, exact):
                   dL/d albedo_c(tap) += g_c[pixel] * C_c / albedo_c(x)
                       * trilerp_weight(tap)
               density (score function, unbiased):
                   real collision at x:  s * 1/rho(x)
                   null collision at x:  s * -1/(rho_max - rho(x))
                 with s = sum_c g_c[pixel] * C_c.

Sampling decisions are fixed under differentiation; Russian roulette
decisions are detached too, so gradient checks turn RR off.

Port notes: the custom_vjp is a torch.autograd.Function called through
render_diff.  The lax.while_loops are host loops: the Woodcock loops and
the fused replay's plain version read their condition once every
WOODCOCK_CHECK_EVERY and CHECK_EVERY steps (a step on which no lane runs
changes nothing, and a fused-replay lane advances one step per
evaluation whatever pool it is in), the bounce loops once per bounce.
On the card the fused replay's stages run through csrc/replaybody.cu
(ops/replaybody.run_stage), which stops where that loop stops, and the
bounce-lockstep replays (one-level, and the nested two-level one) through
csrc/nestedreplay.cu (ops/nestedreplay.run: each lane to its end in one
launch, or under deterministic algorithms the eager loop's lockstep).
`.at[].add` is `index_add_`; a lane that adds nothing adds 0.0 to row 0
instead of being dropped, which leaves every sum as it is.  On the card
index_add_ and the kernel add with atomics, so cotangents agree with the
CPU's to float-summation order, unless
torch.use_deterministic_algorithms is on.  The module globals
DIFF_MAX_BRICKS, DIFF_CASCADE_FACTOR and REPLAY_CASCADE are the keyword
arguments max_bricks, cascade_factor and cascade, with the same
defaults.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Optional, Tuple

import torch

from ..constants import EPSILON
from ..ops import aabb, camera as cam, nestedreplay, phase, replaybody
from ..ops.nestedreplay import WOODCOCK_CHECK_EVERY, one_row_sum
from ..ops.grid import Grid, _to_index, sample, tap_voxels, volume_to_grid
from ..ops.rng import RngState, make_rng, next_float, next_uint32
from ..scene.types import (
    Bsdf, Medium, RenderSettings, Scene, _f32, loader_device,
)
from . import fast, integrator, naive

#: fused-replay body evaluations per host read of the pending count
CHECK_EVERY = 8


@dataclasses.dataclass(frozen=True)
class SceneSpec:
    """Every scene parameter except the two grids."""

    box_min: Tuple[float, float, float] = (-0.5, -0.5, -0.5)
    box_max: Tuple[float, float, float] = (0.5, 0.5, 0.5)
    scale: float = 1.0
    max_density: float = 1.0
    g: float = 0.0
    roughness: Tuple[float, float] = (0.1, 0.1)
    eta: float = 1.05 / 1.01
    le: Tuple[float, float, float] = (1.0, 1.0, 1.0)

    @classmethod
    def from_scene(cls, scene: Scene) -> "SceneSpec":
        med = scene.medium
        return cls(
            box_min=tuple(float(v) for v in med.box_min),
            box_max=tuple(float(v) for v in med.box_max),
            scale=float(med.scale),
            max_density=float(med.max_density),
            g=float(med.g),
            roughness=tuple(float(v) for v in scene.bsdf.roughness),
            eta=float(scene.bsdf.eta),
            le=tuple(float(v) for v in scene.le),
        )

    def build(self, density_data, albedo_data, device="cuda") -> Scene:
        """The Scene on `device` (the card unless the caller asks for the
        CPU; raises without a card).  No affine albedo fit: a per-voxel
        albedo is a full table, as in the JAX package."""
        device = loader_device(device)
        return Scene(
            medium=Medium(
                density=Grid(torch.as_tensor(density_data).to(device)),
                albedo=Grid(torch.as_tensor(albedo_data).to(device)),
                box_min=_f32(self.box_min, device),
                box_max=_f32(self.box_max, device),
                scale=_f32(self.scale, device),
                max_density=_f32(self.max_density, device),
                g=_f32(self.g, device),
            ),
            bsdf=Bsdf(
                roughness=_f32(self.roughness, device),
                eta=_f32(self.eta, device),
            ),
            le=_f32(self.le, device),
        )


@dataclasses.dataclass(frozen=True)
class CameraSpec:
    """Camera parameters."""

    res_x: int = 400
    res_y: int = 400
    fov_x_deg: float = 0.7
    position: Tuple[float, float, float] = (0.0, 0.0, 100.0)
    mitsuba_comparable: bool = True
    #: optional look-at pose for multi-view inverse rendering; when set,
    #: the camera orients from `position` toward `look_at` (reference:
    #: Camera.h lookAt:107-122) instead of the default -z axis pose
    look_at: Optional[Tuple[float, float, float]] = None
    up: Tuple[float, float, float] = (0.0, 1.0, 0.0)

    def build(self, device="cuda") -> cam.Camera:
        device = loader_device(device)
        if self.look_at is not None:
            return cam.make_camera_look_at(
                self.position, self.look_at, self.up,
                self.res_x, self.res_y, self.fov_x_deg, device=device,
            )
        return cam.make_camera(
            self.res_x, self.res_y, self.fov_x_deg, self.position,
            self.mitsuba_comparable, device=device,
        )


def _trilerp_taps(grid_shape_zyx, box_min, box_max, p_world):
    """Flat tap indices + lerp weights for scatter-adding adjoints at the
    same 8 taps ops/grid.sample_trilinear reads."""
    nz, ny, nx = grid_shape_zyx[:3]
    p01 = (p_world - box_min) / (box_max - box_min)
    coord = volume_to_grid(grid_shape_zyx, p01)
    c0 = torch.floor(coord)
    i0 = _to_index(c0)
    f = coord - c0
    taps = []
    for dz in (0, 1):
        for dy in (0, 1):
            for dx in (0, 1):
                ix = torch.clamp(i0[..., 0] + dx, 0, nx - 1)
                iy = torch.clamp(i0[..., 1] + dy, 0, ny - 1)
                iz = torch.clamp(i0[..., 2] + dz, 0, nz - 1)
                w = (
                    (f[..., 0] if dx else 1.0 - f[..., 0])
                    * (f[..., 1] if dy else 1.0 - f[..., 1])
                    * (f[..., 2] if dz else 1.0 - f[..., 2])
                )
                taps.append(((iz * ny + iy) * nx + ix, w))
    return taps


def _build_brick_tab(density_data: torch.Tensor, max_bricks=None):
    """Two-level majorant tables for the differentiable pass: dilated
    per-brick majorants with multiplicative+additive headroom, so the
    null-collision score -1/(rho_maxb - rho) stays bounded at the brick's
    argmax voxel (any valid majorant keeps the estimator exact), plus the
    Chebyshev empty-space leap channel.  Returns (major, cheb, brick)."""
    dd = density_data.detach()
    brick = fast.pick_brick(
        tuple(dd.shape), *(() if max_bricks is None else (max_bricks,))
    )
    major = fast.brick_majorants(dd, brick)
    # 10% of the grid max bounds the null score at ~-10/max
    slack = 0.1 * torch.clamp(torch.amax(dd), min=1e-6)
    major = torch.where(major > 0.0, major * 1.05 + slack, 0.0)
    cheb = fast.brick_chebyshev_distance(major)
    return major, cheb, brick


class _ReplayState(NamedTuple):
    o: torch.Tensor
    d: torch.Tensor
    throughput: torch.Tensor
    radiance: torch.Tensor
    alive: torch.Tensor
    rng: RngState
    d_density: torch.Tensor  # flat (Nvox,) cotangent accumulator
    d_albedo: torch.Tensor  # flat (Nvox, C) cotangent accumulator


def _albedo_adjoint(g_lane, albedo, mask, n_chan):
    """dC/d albedo_c = C_c / albedo_c on `mask` lanes, padded with the
    alpha channel's zero to the albedo grid's channel count."""
    adj = torch.where(mask[:, None], g_lane / torch.clamp(albedo, min=1e-8), 0.0)
    pad = torch.zeros(adj.shape[:-1] + (1,), dtype=torch.float32,
                      device=adj.device)
    return torch.cat([adj, pad], dim=-1)[:, :n_chan]


def _any(mask) -> bool:
    """A host read of a nested replay's loop condition (counted in
    ops/nestedreplay.KERNEL.plain_reads)."""
    nestedreplay.KERNEL.plain_reads += 1
    return bool(torch.any(mask))


def _replay_bounce(scene, settings, st, s_lane, g_lane, record, taps=None):
    """One bounce identical to integrator.bounce_step (aabb boundary),
    optionally scatter-adding adjoints (record=True for pass B).  The
    cotangent buffers are accumulated in place.  A list given as `taps`
    receives the voxels read and, in pass B, added to (("density",
    ...), ("albedo", ...), ("d_density", ...), ("d_albedo", ...);
    ops/nestedreplay.nested_bytes)."""
    med = scene.medium
    o, d, tput, rad, alive, rng = (
        st.o, st.d, st.throughput, st.radiance, st.alive, st.rng
    )
    d_density, d_albedo = st.d_density, st.d_albedo

    isect = aabb.aabb_intersect(med.box_min, med.box_max, o, d)
    miss = alive & ~isect.hit
    rad = torch.where(miss[:, None], rad + tput * scene.le, rad)
    alive = alive & isect.hit
    in_medium = alive & isect.inside_volume

    # --- Woodcock with score-function recording --------------------------
    scale = med.scale
    rho_max = med.max_density
    inv_sigmat = 1.0 / (scale * rho_max)
    extent = med.box_max - med.box_min
    t = torch.zeros(isect.dist.shape, dtype=torch.float32, device=o.device)
    running = in_medium
    while _any(running):
        for _ in range(WOODCOCK_CHECK_EVERY):
            u1, rng = next_float(rng, running)
            step = -torch.log(torch.clamp(u1, min=EPSILON)) * inv_sigmat
            t_new = t + step
            p = o + t_new[:, None] * d
            p01 = (p - med.box_min) / extent
            rho = sample(med.density, p01, settings.interpolation)
            u2, rng = next_float(rng, running)
            overran = t_new > isect.dist
            accepted = ~(scale * rho * inv_sigmat < u2)
            if taps is not None:
                taps.append(("density", tap_voxels(
                    med.density, p01, settings.interpolation)[running]))
            # Score terms: every evaluated collision inside [0, max_t];
            # overruns past the boundary were never realised collisions.
            if record:
                is_real = running & accepted & ~overran
                is_null = running & ~accepted & ~overran
                score = torch.where(
                    is_real,
                    1.0 / torch.clamp(rho, min=1e-8),
                    torch.where(
                        is_null,
                        -1.0 / torch.clamp(rho_max - rho, min=1e-8), 0.0,
                    ),
                )
                val = s_lane * score
                tl = _trilerp_taps(
                    med.density.data.shape, med.box_min, med.box_max, p
                )
                for idx, w in tl:
                    d_density.index_add_(0, idx, val * w)
                if taps is not None:
                    taps.append(("d_density", torch.stack(
                        [idx for idx, _ in tl], -1)[is_real | is_null]))
            terminated = overran | accepted
            t = torch.where(running, t_new, t)
            running = running & ~terminated
    scattered = in_medium & (t < isect.dist)
    boundary = alive & ~scattered

    # --- boundary event ---------------------------------------------------
    o_bound = o + d * isect.dist[:, None]
    o_b, d_b, t_b, rng = integrator.boundary_event(
        scene, settings, isect.normal, o_bound, d, tput, rng, boundary
    )

    # --- scatter event + albedo adjoint ----------------------------------
    o_s = o + d * t[:, None] - d * EPSILON
    albedo = integrator.sample_albedo(scene, o_s, settings)
    alb = med.albedo.data
    if taps is not None:
        taps.append(("albedo", tap_voxels(
            med.albedo, aabb.aabb_transform(med.box_min, med.box_max, o_s),
            settings.interpolation)[scattered]))
    if record:
        adj = _albedo_adjoint(g_lane, albedo, scattered, alb.shape[-1])
        tl = _trilerp_taps(alb.shape, med.box_min, med.box_max, o_s)
        if alb.numel() == alb.shape[-1]:
            # a constant (1-row) albedo: every tap is the row, so reduce
            # the taps' adjoints in double, as csrc/nestedreplay.cu does,
            # instead of adding each lane's in float32
            d_albedo += one_row_sum([adj * w[:, None] for _, w in tl])
        else:
            for idx, w in tl:
                d_albedo.index_add_(0, idx, adj * w[:, None])
        if taps is not None:
            taps.append(("d_albedo", torch.stack(
                [idx for idx, _ in tl], -1)[scattered]))
    d_s, rng = phase.sample_phase(d, med.g, rng, active=scattered)

    sc, bd = scattered[:, None], boundary[:, None]
    o = torch.where(sc, o_s, torch.where(bd, o_b, o))
    d = torch.where(sc, d_s, torch.where(bd, d_b, d))
    tput = torch.where(sc, tput * albedo, torch.where(bd, t_b, tput))

    if settings.russian_roulette:
        tput, alive, _, rng = integrator.russian_roulette(tput, alive, rng, alive)

    return _ReplayState(
        o=o, d=d, throughput=tput, radiance=rad, alive=alive, rng=rng,
        d_density=d_density, d_albedo=d_albedo,
    )


class _Geometry(NamedTuple):
    """Per-scene constants of the two-level replay."""

    nx: int
    ny: int
    nz: int
    nby: int
    nbx: int
    res_minus_1: torch.Tensor
    extent: torch.Tensor
    brick_size: torch.Tensor
    brick_hi: torch.Tensor
    major_flat: torch.Tensor
    leap_flat: torch.Tensor
    epsw: torch.Tensor
    density_flat: torch.Tensor
    albedo_flat: torch.Tensor
    const_alb: bool


def _geometry(scene: Scene, tables) -> _Geometry:
    med = scene.medium
    dev = scene.device
    major, cheb, brick = tables
    bz_, by_, bx_ = brick
    nz, ny, nx = med.density.data.shape
    nbz, nby, nbx = major.shape
    alb_shape = med.albedo.data.shape
    res_minus_1 = torch.tensor([nx - 1, ny - 1, nz - 1], dtype=torch.float32,
                               device=dev)
    extent = med.box_max - med.box_min
    brick_size = torch.tensor([bx_, by_, bz_], dtype=torch.float32, device=dev)
    edge_world = brick_size * (extent / res_minus_1)
    min_edge = torch.amin(edge_world)
    return _Geometry(
        nx=nx, ny=ny, nz=nz, nby=nby, nbx=nbx,
        res_minus_1=res_minus_1, extent=extent, brick_size=brick_size,
        brick_hi=torch.tensor([nbx - 1, nby - 1, nbz - 1], dtype=torch.int64,
                              device=dev),
        major_flat=major.reshape(-1),
        leap_flat=(torch.clamp(cheb.reshape(-1) - 1.0, min=0.0) * min_edge
                   * (1.0 - 1e-6)),
        epsw=torch.amax(extent) * 1e-6,
        density_flat=med.density.data.reshape(-1),
        albedo_flat=med.albedo.data.reshape(-1, alb_shape[-1]),
        const_alb=all(s == 1 for s in alb_shape[:3]),
    )


class _Step(NamedTuple):
    """One two-level tracking step's outcome."""

    t: torch.Tensor
    brick_exit: torch.Tensor
    inv_sig: torch.Tensor
    rho_loc: torch.Tensor
    rng: RngState
    inside: torch.Tensor
    accepted: torch.Tensor
    rho: torch.Tensor
    tap_flat: torch.Tensor
    overran_step: torch.Tensor
    overran_empty: torch.Tensor
    need_brick: torch.Tensor
    bflat: torch.Tensor


def _track_step(scene, geo: _Geometry, o, d, running, t, brick_exit,
                inv_sig, rho_loc, max_t, rng) -> _Step:
    """One two-level tracking step of the running lanes: a brick probe
    (dilated majorant, Chebyshev leap over empty bricks), then one
    Woodcock step under the brick's majorant with the stochastic tap.
    The nested and the fused replays both run this one function."""
    med = scene.medium
    scale = med.scale
    need_brick = running & (t >= brick_exit)
    p_now = o + (t + geo.epsw)[:, None] * d
    coordn = (
        torch.clamp((p_now - med.box_min) / geo.extent, 0.0, 1.0)
        * geo.res_minus_1
    )
    bi = torch.minimum(
        torch.clamp(torch.floor(coordn / geo.brick_size).to(torch.int64), min=0),
        geo.brick_hi,
    )
    bflat = (bi[:, 2] * geo.nby + bi[:, 1]) * geo.nbx + bi[:, 0]
    idx_b = torch.where(need_brick, bflat, 0)
    rho_b = geo.major_flat[idx_b]
    leap_b = geo.leap_flat[idx_b]
    up = (d > 0.0).to(torch.float32)
    bound_coord = (bi.to(torch.float32) + up) * geo.brick_size
    bound_world = med.box_min + geo.extent * bound_coord / geo.res_minus_1
    okd = torch.abs(d) > 1e-12
    t_axes = torch.where(
        okd, (bound_world - o) / torch.where(okd, d, 1.0), torch.inf
    )
    exit_new = torch.maximum(torch.amin(t_axes, dim=-1), t + geo.epsw)
    brick_exit = torch.where(need_brick, exit_new, brick_exit)
    inv_sig = torch.where(
        need_brick,
        torch.where(
            rho_b > 0.0, 1.0 / (scale * torch.clamp(rho_b, min=1e-30)),
            torch.inf,
        ),
        inv_sig,
    )
    rho_loc = torch.where(need_brick, rho_b, rho_loc)

    probe_empty = need_brick & (rho_b <= 0.0)
    t_leap = torch.maximum(exit_new, t + leap_b)
    overran_empty = probe_empty & (t_leap >= max_t)

    stepping = running & ~probe_empty
    u1, rng = next_float(rng, stepping)
    step = torch.where(
        stepping, -torch.log(torch.clamp(u1, min=EPSILON)) * inv_sig, 0.0
    )
    t_cand = t + step
    eff_exit = torch.minimum(brick_exit, max_t)
    crossed = stepping & (t_cand >= eff_exit)
    inside = stepping & ~crossed

    p = o + t_cand[:, None] * d
    coord = (
        torch.clamp((p - med.box_min) / geo.extent, 0.0, 1.0) * geo.res_minus_1
    )
    tap_bits, rng = next_uint32(rng, inside)
    tap = fast._stochastic_tap(coord, tap_bits)
    ix = torch.clamp(tap[:, 0], 0, geo.nx - 1)
    iy = torch.clamp(tap[:, 1], 0, geo.ny - 1)
    iz = torch.clamp(tap[:, 2], 0, geo.nz - 1)
    tap_flat = (iz * geo.ny + iy) * geo.nx + ix
    rho = geo.density_flat[torch.where(inside, tap_flat, 0)]
    u2, rng = next_float(rng, inside)
    accepted = inside & ~(scale * rho * inv_sig < u2)

    overran_step = crossed & (max_t <= brick_exit)
    transit = crossed & ~overran_step
    t = torch.where(
        probe_empty,
        torch.minimum(t_leap, max_t),
        torch.where(
            transit,
            brick_exit,
            torch.where(
                overran_step, torch.maximum(t, max_t),
                torch.where(inside, t_cand, t),
            ),
        ),
    )
    brick_exit = torch.where(probe_empty, -1.0, brick_exit)
    return _Step(t, brick_exit, inv_sig, rho_loc, rng, inside, accepted, rho,
                 tap_flat, overran_step, overran_empty, need_brick, bflat)


def _record_density(dd, s: _Step, s_lane):
    """Single-tap score terms with the brick's (local) majorant."""
    is_null = s.inside & ~s.accepted
    score = torch.where(
        s.accepted,
        1.0 / torch.clamp(s.rho, min=1e-8),
        torch.where(
            is_null, -1.0 / torch.clamp(s.rho_loc - s.rho, min=1e-8), 0.0
        ),
    )
    dd.index_add_(0, torch.where(s.inside, s.tap_flat, 0), s_lane * score)


def _record_albedo(da, geo: _Geometry, g_lane, albedo, scat, alb_idx):
    adj = _albedo_adjoint(g_lane, albedo, scat, geo.albedo_flat.shape[-1])
    if geo.const_alb:
        # constant albedo: a full-width scatter onto a 1-row table is
        # degenerate — reduce instead
        da += torch.sum(adj, dim=0, keepdim=True)
    else:
        da.index_add_(0, torch.where(scat, alb_idx, 0), adj)


def _replay_bounce_2l(scene, settings, st, s_lane, g_lane, record, tables,
                      taps=None):
    """Two-level, stochastic-tap variant of _replay_bounce: per-brick
    dilated majorants (with score headroom), Chebyshev empty-space leaps
    and single-tap stochastic trilinear filtering — the fastSK estimator
    family, made differentiable.  Adjoints scatter to ONE tap per density
    evaluation, and the null score uses the brick majorant the sampler
    used.  `taps` as in _replay_bounce, with ("brick", brick rows read)."""
    med = scene.medium
    geo = _geometry(scene, tables)
    o, d, tput, rad, alive, rng = (
        st.o, st.d, st.throughput, st.radiance, st.alive, st.rng
    )
    d_density, d_albedo = st.d_density, st.d_albedo

    isect = aabb.aabb_intersect(med.box_min, med.box_max, o, d)
    miss = alive & ~isect.hit
    rad = torch.where(miss[:, None], rad + tput * scene.le, rad)
    alive = alive & isect.hit
    running = alive & isect.inside_volume
    max_t = isect.dist

    n_lanes = o.shape[0]
    zero1 = torch.zeros((n_lanes,), dtype=torch.float32, device=o.device)
    t, brick_exit, inv_sig, rho_loc = zero1, zero1 - 1.0, zero1, zero1
    scattered = torch.zeros((n_lanes,), dtype=torch.bool, device=o.device)
    tap_saved = torch.zeros((n_lanes,), dtype=torch.int64, device=o.device)
    while _any(running):
        for _ in range(WOODCOCK_CHECK_EVERY):
            s = _track_step(scene, geo, o, d, running, t, brick_exit, inv_sig,
                            rho_loc, max_t, rng)
            t, brick_exit, inv_sig, rho_loc, rng = s[:5]
            if taps is not None:
                taps += [("brick", s.bflat[s.need_brick]),
                         ("density", s.tap_flat[s.inside])]
                if record:
                    taps.append(("d_density", s.tap_flat[s.inside]))
            if record:
                _record_density(d_density, s, s_lane)
            done = s.accepted | s.overran_step | s.overran_empty
            scattered = scattered | s.accepted
            tap_saved = torch.where(s.accepted, s.tap_flat, tap_saved)
            running = running & ~done
    boundary = alive & ~scattered

    # --- boundary event (shared physics helpers) --------------------------
    o_bound = o + d * isect.dist[:, None]
    o_b, d_b, t_b, rng = integrator.boundary_event(
        scene, settings, isect.normal, o_bound, d, tput, rng, boundary
    )

    # --- scatter event: albedo at the accepted tap ------------------------
    alb_idx = torch.zeros_like(tap_saved) if geo.const_alb else tap_saved
    albedo = geo.albedo_flat[alb_idx][:, :3]
    if taps is not None:
        taps.append(("albedo", alb_idx[scattered]))
        if record:
            taps.append(("d_albedo", alb_idx[scattered]))
    if record:
        _record_albedo(d_albedo, geo, g_lane, albedo, scattered, alb_idx)
    d_s, rng = phase.sample_phase(d, med.g, rng, active=scattered)

    o_s = o + d * t[:, None] - d * EPSILON
    sc = scattered[:, None]
    o = torch.where(sc, o_s, torch.where(boundary[:, None], o_b, o))
    d = torch.where(sc, d_s, d_b)
    tput = torch.where(sc, tput * albedo, t_b)

    if settings.russian_roulette:
        tput, alive, _, rng = integrator.russian_roulette(tput, alive, rng, alive)

    return _ReplayState(
        o=o, d=d, throughput=tput, radiance=rad, alive=alive, rng=rng,
        d_density=d_density, d_albedo=d_albedo,
    )


class _Lanes(NamedTuple):
    """Per-lane state of the fused replay's pool."""

    o: torch.Tensor
    d: torch.Tensor
    tput: torch.Tensor
    rad: torch.Tensor
    alive: torch.Tensor
    rng: RngState
    bounce: torch.Tensor
    seg: torch.Tensor  # a segment (AABB hit .. event) is in flight
    in_med: torch.Tensor
    t: torch.Tensor
    brick_exit: torch.Tensor
    inv_sig: torch.Tensor
    rho_loc: torch.Tensor
    max_t: torch.Tensor
    normal: torch.Tensor
    lane_id: torch.Tensor
    s_lane: torch.Tensor
    g_lane: torch.Tensor


def _replay_body(scene, settings, geo: _Geometry, record, dd, da, c: _Lanes,
                 taps=None) -> _Lanes:
    """One evaluation of the fused replay's per-lane state machine (the
    plain version of csrc/replaybody.cu): a lane starts a segment (AABB
    intersect), advances one tracking step, or applies its scatter or
    boundary event, then Russian roulette and the bounce cap.  With
    record, the adjoints are added into dd and da in place.  `taps`, when
    a list, gains ("tap", flat density indices), ("brick", brick rows) and
    ("albedo", albedo rows) of the lanes that read them, and ("state", the
    lanes that read and that change each per-lane field)
    (ops/replaybody.replay_bytes)."""
    med = scene.medium
    cap = settings.max_path_length
    # -- A: segment start (the nested bounce preamble) --------------------
    start = c.alive & ~c.seg
    isect = aabb.aabb_intersect(med.box_min, med.box_max, c.o, c.d)
    miss = start & ~isect.hit
    rad = torch.where(miss[:, None], c.rad + c.tput * scene.le, c.rad)
    alive = c.alive & ~miss
    st2 = start & isect.hit
    seg = c.seg | st2
    t = torch.where(st2, 0.0, c.t)
    brick_exit = torch.where(st2, -1.0, c.brick_exit)
    inv_sig = torch.where(st2, 0.0, c.inv_sig)
    rho_loc = torch.where(st2, 0.0, c.rho_loc)
    max_t = torch.where(st2, isect.dist, c.max_t)
    normal = torch.where(st2[:, None], isect.normal, c.normal)
    in_med = torch.where(st2, isect.inside_volume, c.in_med)
    # entering from outside: no tracking — straight to boundary
    imm_bnd = st2 & ~isect.inside_volume

    # -- B: one two-level tracking step -----------------------------------
    o, d, tput = c.o, c.d, c.tput
    running = seg & alive & in_med
    s = _track_step(scene, geo, o, d, running, t, brick_exit, inv_sig,
                    rho_loc, max_t, c.rng)
    t, brick_exit, inv_sig, rho_loc, rng = s[:5]
    if record:
        _record_density(dd, s, c.s_lane)

    # -- C: events for lanes whose segment just completed -----------------
    scat_now = s.accepted
    trk_done = s.accepted | s.overran_step | s.overran_empty
    bnd_now = (trk_done & ~s.accepted) | imm_bnd
    done_now = trk_done | imm_bnd
    seg = seg & ~done_now

    o_bound = o + d * max_t[:, None]
    o_b, d_b, t_b, rng = integrator.boundary_event(
        scene, settings, normal, o_bound, d, tput, rng, bnd_now
    )

    alb_idx = torch.zeros_like(s.tap_flat) if geo.const_alb else s.tap_flat
    albedo = geo.albedo_flat[torch.where(scat_now, alb_idx, 0)][:, :3]
    if record:
        _record_albedo(da, geo, c.g_lane, albedo, scat_now, alb_idx)
    d_s, rng = phase.sample_phase(d, med.g, rng, active=scat_now)

    o_s = o + d * t[:, None] - d * EPSILON
    sc, bd = scat_now[:, None], bnd_now[:, None]
    o = torch.where(sc, o_s, torch.where(bd, o_b, o))
    d = torch.where(sc, d_s, torch.where(bd, d_b, d))
    tput = torch.where(sc, tput * albedo, torch.where(bd, t_b, tput))

    if settings.russian_roulette:
        tput, alive, _, rng = integrator.russian_roulette(
            tput, alive, rng, done_now & alive
        )

    bounce = torch.where(done_now, c.bounce + 1, c.bounce)
    alive = alive & ~(done_now & (bounce >= cap))
    new = _Lanes(o, d, tput, rad, alive, rng, bounce, seg, in_med, t,
                 brick_exit, inv_sig, rho_loc, max_t, normal, c.lane_id,
                 c.s_lane, c.g_lane)
    if taps is not None:
        # the lanes whose evaluation reads each field before it writes it
        ggx = settings.bsdf_kind == "ggx"
        none = torch.zeros_like(c.alive)
        in_seg = running & ~st2  # a segment that began before
        no_probe = running & ~s.need_brick
        reads = {
            "alive": torch.ones_like(c.alive), "seg": c.alive,
            "in_med": c.alive & c.seg, "o": start | running,
            "d": start | running,
            "tput": (miss | scat_now | (bnd_now if ggx else none)
                     | (done_now if settings.russian_roulette else none)),
            "rad": miss, "normal": bnd_now & ~st2 if ggx else none,
            "t": in_seg, "brick_exit": in_seg, "max_t": in_seg,
            "inv_sig": no_probe,
            "rho_loc": (no_probe & s.inside & ~s.accepted if record
                        else none),
            "bounce": done_now,
            "s_lane": s.inside if record else none,
            "g_lane": scat_now if record else none,
        }
        taps += [("tap", s.tap_flat[s.inside]),
                 ("brick", s.bflat[s.need_brick]),
                 ("albedo", alb_idx[scat_now]),
                 ("state", replaybody.lane_traffic(c, new, reads))]
    return new


def replay_context(scene, settings, tables, record, d_density=None,
                   d_albedo=None) -> replaybody.ReplayContext:
    """The replay kernel's context for `scene` and its brick tables; its
    plain version is the eager body, adding into d_density and d_albedo
    with record."""
    geo = _geometry(scene, tables)
    return replaybody.make_context(
        scene, settings, geo, record, d_density, d_albedo,
        functools.partial(_replay_body, scene, settings, geo, record,
                          d_density, d_albedo),
    )


def _replay_2l_fused(scene, settings, o0, d0, rng0, s_lane, g_lane,
                     record, d_density0, d_albedo0, tables,
                     cascade=True, cascade_factor=2, min_width=None,
                     check_every=CHECK_EVERY, stats=None, eager_body=False):
    """Fused single-loop two-level replay with cascade tail compaction.

    One loop over steps with a per-lane state machine (the fastSK
    structure): each evaluation a lane either starts a segment (AABB
    intersect), advances one tracking step, or applies its scatter or
    boundary event.  The per-lane draw sequence is the nested replay's,
    so radiance and throughput are bit-identical to it.

    cascade=True: pools of shrinking width; when the pending (alive)
    count fits the next pool, finished lanes write their results to
    lane-id-indexed output buffers and survivors are stably compacted
    into the narrower pool.  The RNG travels with the lane.

    Each stage runs through ops/replaybody.run_stage on the card
    (csrc/replaybody.cu: gated chains of one-evaluation launches, the last
    stage one drain launch) and through the eager body, `_replay_body`,
    on the CPU or with eager_body=True (replaybody.loop_stage: the
    alive count read every check_every evaluations).

    `stats`, when a dict, gains "iterations" (body evaluations) and
    "rows" (their summed pool widths)."""
    dev = o0.device
    n_total = o0.shape[0]
    dd, da = d_density0, d_albedo0
    ctx = replay_context(scene, settings, tables, record, dd, da)
    use_kernel = replaybody.route(dev.type, eager_body)

    if cascade:
        widths = fast._cascade_widths(
            n_total, cascade_factor,
            fast._MIN_WIDTH if min_width is None else min_width,
        )
    else:
        widths = [n_total]

    # lane-id-indexed per-lane output buffers; row n_total takes the
    # writes of lanes still alive at a flush (dropped at the end)
    outs = [torch.zeros((n_total + 1, 3), dtype=torch.float32, device=dev)
            for _ in range(4)]

    # every per-lane field its own contiguous tensor: the kernel updates
    # the pool in place
    def zeros(*shape, dtype=torch.float32):
        return torch.zeros((n_total,) + shape, dtype=dtype, device=dev)

    carry = _Lanes(
        o=o0.contiguous().clone(), d=d0.contiguous().clone(),
        tput=torch.ones((n_total, 3), dtype=torch.float32, device=dev),
        rad=zeros(3),
        alive=torch.ones((n_total,), dtype=torch.bool, device=dev),
        rng=RngState(rng0.state.contiguous().clone(), rng0.inc.contiguous()),
        bounce=zeros(dtype=torch.int64),
        seg=zeros(dtype=torch.bool), in_med=zeros(dtype=torch.bool),
        t=zeros(), brick_exit=zeros() - 1.0, inv_sig=zeros(), rho_loc=zeros(),
        max_t=zeros(), normal=zeros(3),
        lane_id=torch.arange(n_total, dtype=torch.int64, device=dev),
        s_lane=s_lane.contiguous(), g_lane=g_lane.contiguous(),
    )

    def flush(c: _Lanes):
        """Write finished lanes' final state to the lane-id buffers.  A
        dead lane's fields never change again, so re-flushing a dead lane
        that survived a pool cut rewrites identical values."""
        idx = torch.where(c.alive, n_total, c.lane_id)
        for buf, val in zip(outs, (c.o, c.d, c.tput, c.rad)):
            buf.index_copy_(0, idx, val)

    n_iter = rows = 0
    for stage, width in enumerate(widths):
        last = stage == len(widths) - 1
        thresh = 0 if last else widths[stage + 1]
        if use_kernel:
            carry, n = replaybody.run_stage(ctx, carry, thresh, check_every,
                                            last)
        else:
            carry, n = replaybody.loop_stage(ctx, carry, thresh, check_every,
                                             replaybody.plain_body)
        n_iter += n
        rows += n * width
        flush(carry)
        if not last:
            order = torch.argsort((~carry.alive).to(torch.int32), stable=True)
            carry = fast._take_lanes(carry, order[: widths[stage + 1]])
    if stats is not None:
        stats["iterations"] = n_iter
        stats["rows"] = rows

    out_o, out_d, out_tput, out_rad = (buf[:n_total] for buf in outs)
    # rng is the INITIAL state: the final per-lane states live
    # pool-permuted in the carry and no caller continues sampling from a
    # replay's rng
    return _ReplayState(
        o=out_o, d=out_d, throughput=out_tput, radiance=out_rad,
        alive=torch.zeros((n_total,), dtype=torch.bool, device=dev), rng=rng0,
        d_density=dd, d_albedo=da,
    )


def _nested_loop(scene, settings, tables, record, d_density0, d_albedo0, o0,
                 d0, rng0, s_lane, g_lane, taps=None) -> _ReplayState:
    """The bounce-lockstep nested replay, one-level (tables None) or
    two-level, as eager torch: the plain version of csrc/nestedreplay.cu
    (counted in ops/nestedreplay.KERNEL.plain_passes).  `taps`, a list,
    gains each bounce's taps (_replay_bounce)."""
    nestedreplay.KERNEL.plain_passes += 1
    n = o0.shape[:-1]
    dev = o0.device
    st = _ReplayState(
        o=o0, d=d0,
        throughput=torch.ones(n + (3,), dtype=torch.float32, device=dev),
        radiance=torch.zeros(n + (3,), dtype=torch.float32, device=dev),
        alive=torch.ones(n, dtype=torch.bool, device=dev),
        rng=rng0,
        d_density=d_density0, d_albedo=d_albedo0,
    )
    bounce = 0
    while bounce < settings.max_path_length and _any(st.alive):
        if tables is not None:
            st = _replay_bounce_2l(scene, settings, st, s_lane, g_lane,
                                   record, tables, taps)
        else:
            st = _replay_bounce(scene, settings, st, s_lane, g_lane, record,
                                taps)
        bounce += 1
    return st


def nested_context(scene, settings, tables, record, d_density=None,
                   d_albedo=None) -> nestedreplay.NestedContext:
    """The nested replay's kernel context (one-level for tables None); its
    plain version is the eager loop, adding into d_density and d_albedo
    with record."""
    geo = None if tables is None else _geometry(scene, tables)

    def plain(o0, d0, rng0, s_lane, g_lane, taps=None):
        st = _nested_loop(scene, settings, tables, record, d_density,
                          d_albedo, o0, d0, rng0, s_lane, g_lane, taps)
        return (st.o, st.d, st.throughput, st.radiance, st.alive,
                st.rng.state)

    return nestedreplay.make_context(scene, settings, geo, record, d_density,
                                     d_albedo, plain)


def _replay(scene, settings, o0, d0, rng0, s_lane, g_lane, record,
            d_density0, d_albedo0, tables=None, fused=True, cascade=True,
            cascade_factor=2, min_width=None, check_every=CHECK_EVERY,
            stats=None, eager_body=False):
    """Replay every lane's path: the fused two-level replay (tables given,
    fused=True; on the card through csrc/replaybody.cu unless eager_body),
    or the bounce-lockstep nested replay, one- or two-level (on the card
    through csrc/nestedreplay.cu unless eager_body; the eager loop
    `_nested_loop` on the CPU).  With record=True the adjoints are added
    into d_density0 and d_albedo0 in place; with record=False they are not
    touched."""
    if tables is not None and fused:
        return _replay_2l_fused(
            scene, settings, o0, d0, rng0, s_lane, g_lane, record,
            d_density0, d_albedo0, tables, cascade=cascade,
            cascade_factor=cascade_factor, min_width=min_width,
            check_every=check_every, stats=stats, eager_body=eager_body,
        )
    if not nestedreplay.route(o0.device.type, eager_body):
        return _nested_loop(scene, settings, tables, record, d_density0,
                            d_albedo0, o0, d0, rng0, s_lane, g_lane)
    ctx = nested_context(scene, settings, tables, record, d_density0,
                         d_albedo0)
    o, d, tput, rad, alive, state = nestedreplay.run(ctx, o0, d0, rng0,
                                                     s_lane, g_lane)
    return _ReplayState(o=o, d=d, throughput=tput, radiance=rad, alive=alive,
                        rng=RngState(state, rng0.inc), d_density=d_density0,
                        d_albedo=d_albedo0)


def _lane_setup(camera_obj: cam.Camera, resolution, spp, seed):
    """naive.render_tile's lanes: lane i renders pixel i % (tw * th) with
    path id i, on the camera's device."""
    tw, th = resolution
    dev = camera_obj.inv_view.device
    n_lanes = tw * th * spp
    image_id, pixel_xy = naive.lane_pixels(
        n_lanes, resolution, torch.zeros(2, dtype=torch.float32, device=dev)
    )
    path_id = torch.arange(n_lanes, dtype=torch.int64, device=dev)
    rng = make_rng(seed, path_id)
    o0, d0, rng = cam.generate_rays(camera_obj, pixel_xy, resolution, rng)
    return n_lanes, image_id, o0, d0, rng


def _primal_2l(scene, cam_obj, settings, resolution, spp, seed,
               density_data, albedo_data, max_bricks=None, cascade=True,
               cascade_factor=2, stats=None, eager_body=False):
    """Two-level primal: (image, per-lane radiance).  The single source
    of the primal estimator for render_diff's forward — the backward's
    pass-A elision is correct because the saved radiance IS this
    function's radiance."""
    tw, th = resolution
    dev = density_data.device
    tables = _build_brick_tab(density_data, max_bricks)
    n_lanes, image_id, o0, d0, rng = _lane_setup(cam_obj, resolution, spp, seed)
    out = _replay(
        scene, settings, o0, d0, rng,
        torch.zeros((n_lanes,), dtype=torch.float32, device=dev),
        torch.zeros((n_lanes, 3), dtype=torch.float32, device=dev),
        False, None, None, tables, cascade=cascade,
        cascade_factor=cascade_factor, stats=stats, eager_body=eager_body,
    )
    img = naive.splat(image_id, out.radiance, (tw, th))
    return img, out.radiance


class _RenderDiff(torch.autograd.Function):
    """render_diff's forward (the primal render) and backward (pass A
    unless elided, then pass B)."""

    @staticmethod
    def forward(ctx, density, albedo, seed, scene_spec, camera_spec, settings,
                resolution, spp, two_level, camera, opts):
        dev = density.device
        scene = scene_spec.build(density, albedo, device=dev)
        cam_obj = camera if camera is not None else camera_spec.build(dev)
        max_bricks, cascade_factor, cascade, stats, eager_body = opts
        if two_level:
            primal = {} if stats is not None else None
            img, radiance = _primal_2l(
                scene, cam_obj, settings, resolution, spp, seed, density,
                albedo, max_bricks, cascade, cascade_factor, primal,
                eager_body,
            )
            if stats is not None:
                stats.setdefault("primal_iters", []).append(primal["iterations"])
            # pass A of the backward recomputes exactly this radiance
            # (same replay, record=False): keep it instead
            ctx.save_for_backward(density, albedo, radiance)
        else:
            img, _ = naive.render_tile(
                scene, cam_obj, settings, resolution,
                torch.zeros(2, dtype=torch.float32, device=dev), resolution,
                spp, seed, 0,
            )
            ctx.save_for_backward(density, albedo)
        ctx.args = (seed, scene_spec, cam_obj, settings, resolution, spp,
                    two_level, opts)
        return img

    @staticmethod
    def backward(ctx, g_img):
        density, albedo, *c_saved = ctx.saved_tensors
        (seed, scene_spec, cam_obj, settings, resolution, spp, two_level,
         opts) = ctx.args
        max_bricks, cascade_factor, cascade, stats, eager_body = opts
        dev = density.device
        scene = scene_spec.build(density.detach(), albedo.detach(), device=dev)
        tables = _build_brick_tab(density, max_bricks) if two_level else None
        n_lanes, image_id, o0, d0, rng = _lane_setup(
            cam_obj, resolution, spp, seed
        )
        replay = dict(cascade=cascade, cascade_factor=cascade_factor,
                      eager_body=eager_body)
        if c_saved:
            c_lane = c_saved[0]  # the primal's own radiance: no pass A
        else:
            # Pass A: recompute per-lane contributions C.  record=False
            # never touches the cotangent buffers, so none is allocated.
            c_lane = _replay(
                scene, settings, o0, d0, rng,
                torch.zeros((n_lanes,), dtype=torch.float32, device=dev),
                torch.zeros((n_lanes, 3), dtype=torch.float32, device=dev),
                False, None, None, tables, **replay,
            ).radiance
        g_lane = g_img.reshape(-1, 3)[image_id] * c_lane  # (N, 3) g_c * C_c
        s_lane = torch.sum(g_lane, dim=-1)  # (N,)
        n_chan = albedo.shape[-1]
        zero_d = torch.zeros((density.numel(),), dtype=torch.float32, device=dev)
        zero_a = torch.zeros((albedo.numel() // n_chan, n_chan),
                             dtype=torch.float32, device=dev)
        # Pass B: replay with adjoint scatter.
        pass_b = {} if stats is not None and two_level else None
        out = _replay(scene, settings, o0, d0, rng, s_lane, g_lane, True,
                      zero_d, zero_a, tables, stats=pass_b, **replay)
        if pass_b is not None:
            stats.setdefault("pass_b_iters", []).append(pass_b["iterations"])
        # the seed, the specs, the settings and the camera pose are
        # parameters of the estimator, not differentiated quantities
        return (out.d_density.reshape(density.shape),
                out.d_albedo.reshape(albedo.shape)) + (None,) * 9


def render_diff(
    density_data: torch.Tensor,
    albedo_data: torch.Tensor,
    seed,
    scene_spec: SceneSpec,
    camera_spec: CameraSpec,
    settings: RenderSettings,
    resolution: Tuple[int, int],
    spp: int,
    two_level: bool = False,
    camera: Optional[cam.Camera] = None,
    *,
    max_bricks: Optional[int] = None,
    cascade_factor: float = 2,
    cascade: bool = True,
    stats: Optional[dict] = None,
    eager_body: bool = False,
) -> torch.Tensor:
    """Differentiable render: the (H, W, 3) image (the sum of spp samples
    per pixel) from the grid parameters, on their device.

    two_level=True switches forward AND backward to the sparse-leap
    stochastic-tap estimator (fastSK's family), required for large sparse
    grids.  `camera` (an ops.camera.Camera, no gradient) overrides
    camera_spec's pose.  max_bricks caps the two-level brick table (None:
    fast.pick_brick's default); cascade and cascade_factor shape the
    fused replay's pools.  `stats`, when a dict, gains the fused replay's
    body evaluations per call: "primal_iters" (forward) and
    "pass_b_iters" (backward).  On the card the fused replay runs through
    csrc/replaybody.cu and the one-level backward's replays through
    csrc/nestedreplay.cu; eager_body=True runs their eager bodies instead
    (the plain versions the kernels are held against)."""
    return _RenderDiff.apply(
        density_data, albedo_data, seed, scene_spec, camera_spec, settings,
        tuple(resolution), spp, two_level, camera,
        (max_bricks, cascade_factor, cascade, stats, eager_body),
    )
