"""Shared volumetric path-tracing physics over a ray wavefront.

Port of cudavolumerenderer_tpu/models/integrator.py: the bounce body every
reference kernel repeats (reference: NaiveVolPTsk_kernel.cuh:35-86 and
the identical blocks of the regeneration/streaming/sorting kernels):
intersect the medium AABB → Woodcock free flight → an HG scatter event
or a GGX boundary event → Russian roulette.  The whole wavefront advances
through one bounce as a masked tensor program; the schedulers in the
sibling modules differ only in how lanes are refilled and compacted.

Masked-RNG discipline: every stochastic sub-step draws only on the
lanes that take it, so a path's stream is the same in every scheduler.

Port note: each lax.while_loop is a host loop whose condition reads the
device (trace once per bounce; the Woodcock and boundary-march loops
once every few steps, since a step on which no lane runs changes
nothing).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..constants import EPSILON
from ..ops import aabb, familybody, ggx, gradient, math3, phase, stages
from ..ops import woodcock
from ..ops.grid import sample, tap_voxels
from ..ops.rng import RngState, next_float
from ..scene.types import RenderSettings, Scene

#: march iterations per host read of the boundary-march running mask
_VB_CHECK_EVERY = 8

#: march-iteration cap (reference: max_iterations, Medium.h:62, which is
#: 100000; the JAX package's cap, far past any non-degenerate march)
_VB_MAX_ITERS = 4096


class PathState(NamedTuple):
    """SoA wavefront state (reference AoS analog: Ray.h:19-57)."""

    o: torch.Tensor  # (N, 3) origins
    d: torch.Tensor  # (N, 3) directions
    throughput: torch.Tensor  # (N, 3)
    radiance: torch.Tensor  # (N, 3) accumulated per-lane contribution
    alive: torch.Tensor  # (N,) bool
    rng: RngState  # per-lane RNG
    n_rays: torch.Tensor  # () f32 counter of traced rays


def sample_albedo(scene: Scene, p: torch.Tensor, settings: RenderSettings):
    """Albedo at a world point (reference: Medium.h:145-148): box
    normalization then a volume fetch; returns (..., 3) rgb."""
    med = scene.medium
    p01 = aabb.aabb_transform(med.box_min, med.box_max, p)
    a = sample(med.albedo, p01, settings.interpolation)
    return a[..., :3]


def boundary_event(scene, settings, normal, o_bound, d, tput, rng, mask):
    """Boundary event: local frame from the cached face normal, GGX
    reflect/refract (weight = G1) or the null pass-through BSDF; invalid
    microfacet samples leave direction and throughput unchanged, as the
    reference does.  Returns (o_out, d_out, tput_out, rng) with updates
    only on ``mask`` lanes."""
    fx, fy, fz = math3.frame_from_z(normal)
    wi_local = math3.to_local(fx, fy, fz, math3.normalize(-d))
    if settings.bsdf_kind == "ggx":
        wo_local, weight, valid, rng = ggx.ggx_sample(
            scene.bsdf.roughness, scene.bsdf.eta, wi_local, rng,
            active=mask, mitsuba_comparable=settings.mitsuba_comparable,
        )
        d_bsdf = math3.to_world(fx, fy, fz, wo_local)
    else:  # 'null' pass-through boundary (reference: Bsdf.h:6-15)
        weight = torch.ones(
            wi_local.shape[:-1], dtype=torch.float32, device=d.device
        )
        valid = torch.ones(wi_local.shape[:-1], dtype=torch.bool, device=d.device)
        d_bsdf = d
    ok = torch.logical_and(mask, valid)
    o_out = torch.where(
        mask[..., None],
        torch.where(ok[..., None], o_bound + d_bsdf * EPSILON, o_bound),
        o_bound,
    )
    d_out = torch.where(ok[..., None], d_bsdf, d)
    tput_out = torch.where(ok[..., None], tput * weight[..., None], tput)
    return o_out, d_out, tput_out, rng


def variable_boundary_adjust(
    scene: Scene, settings: RenderSettings, o, d, isect: aabb.Isect,
    rng: RngState, active, taps=None,
):
    """Stochastic density-isosurface boundary search (reference:
    HeterogeneousMediumWithVariableBoundary::intersect, Medium.h:56-107).

    From the AABB hit point, march along the ray (inward when entering,
    backward from the exit face when the origin is inside) in uniform
    random steps of expected boundary_min_step/2 until the density
    gradient magnitude exceeds boundary_threshold; the hit moves there
    and the normalized (negative) density gradient becomes the shading
    normal.  A march that crosses the whole box finds no surface: the
    lane reports no hit with inside_volume flipped (the reference's
    return-false branch).  Draws come from the lane's own stream, as in
    the JAX package.  Returns (isect', rng), updated only on active lanes.
    The loop's iteration count is each running lane's own, so a lane
    marches alone as it does in the pool: on the card one thread runs a
    lane's march in the bounce kernel (csrc/familybody.cu `march`).  A list
    given as `taps` receives the density voxels the probes inside the unit
    cube read (("density", flat voxels); familybody.family_bytes).
    """
    med = scene.medium
    min_step = settings.boundary_min_step
    thresh = settings.boundary_threshold
    extent = med.box_max - med.box_min

    sign = torch.where(isect.inside_volume, -1.0, 1.0)
    temp_d = sign[..., None] * d
    temp_o0 = o + d * (isect.dist + EPSILON)[..., None]
    isect2 = aabb.aabb_intersect(med.box_min, med.box_max, temp_o0, temp_d)
    consider = torch.logical_and(torch.logical_and(active, isect.hit), isect2.hit)

    def w2v(p):
        return (p - med.box_min) / extent

    def grad_at(p, lanes):
        p01 = w2v(p)
        if taps is not None:
            vox, inside = gradient.cd_voxels(med.density, p01, min_step,
                                             settings.interpolation)
            taps.append(("density", vox[lanes][inside[lanes]]))
        return gradient.gradient_cd(
            med.density, p01, min_step, settings.interpolation
        )

    def below(grad):
        return math3.norm(grad) < thresh

    temp_o = temp_o0 - (min_step + EPSILON) * temp_d
    grad = grad_at(temp_o, consider)
    n = isect.dist.shape
    total = torch.zeros(n, dtype=torch.float32, device=o.device)
    new_dist = isect.dist
    no_hit = torch.zeros(n, dtype=torch.bool, device=o.device)
    keep_orig = torch.zeros(n, dtype=torch.bool, device=o.device)
    running = torch.logical_and(consider, below(grad))
    iters = 0
    while iters < _VB_MAX_ITERS and bool(torch.any(running)):
        for _ in range(min(_VB_CHECK_EVERY, _VB_MAX_ITERS - iters)):
            u, rng = next_float(rng, running)
            s = u * min_step
            total = torch.where(running, total + s, total)
            new_dist = torch.where(running, new_dist + sign * s, new_dist)
            # marched out the near side: keep the original AABB result
            ko = torch.logical_and(running, new_dist < 0.0)
            keep_orig = torch.logical_or(keep_orig, ko)
            # marched across to the far boundary: no surface on this segment
            nh = torch.logical_and(
                running,
                torch.logical_and(torch.logical_not(ko), total > isect2.dist),
            )
            no_hit = torch.logical_or(no_hit, nh)
            running = torch.logical_and(
                running, torch.logical_not(torch.logical_or(ko, nh))
            )
            temp_o = torch.where(
                running[..., None], temp_o + temp_d * s[..., None], temp_o
            )
            grad = torch.where(running[..., None],
                               grad_at(temp_o, running), grad)
            iters += 1
            if iters >= _VB_MAX_ITERS:
                keep_orig = torch.logical_or(keep_orig, running)
                running = torch.zeros_like(running)
            else:
                running = torch.logical_and(running, below(grad))

    # surface found with a real march: move the hit there, normal from
    # the gradient (total == 0 keeps the AABB face normal, reference
    # Medium.h:101-104)
    found = torch.logical_and(
        consider, torch.logical_not(torch.logical_or(no_hit, keep_orig))
    )
    moved = torch.logical_and(
        found, torch.logical_and(new_dist > 0.0, total > 0.0)
    )
    dist_out = torch.where(moved, new_dist, isect.dist)
    normal_out = torch.where(moved[..., None], math3.normalize(grad), isect.normal)
    lost = torch.logical_and(consider, no_hit)
    hit_out = torch.logical_and(isect.hit, torch.logical_not(lost))
    inside_out = torch.where(
        lost, torch.logical_not(isect.inside_volume), isect.inside_volume
    )
    return aabb.Isect(
        dist=dist_out, normal=normal_out, inside_volume=inside_out,
        hit=hit_out,
    ), rng


def russian_roulette(tput, alive, rng, mask):
    """Russian roulette (reference: NaiveVolPTsk_kernel.cuh:75-84):
    p = min(1, max(throughput.rgb)); kill with 1-p, else divide.  Draws
    only on ``mask`` lanes.  Returns (tput, alive, killed, rng)."""
    p_survive = torch.clamp(math3.max3(tput), max=1.0)
    u, rng = next_float(rng, mask)
    killed = torch.logical_and(mask, u > p_survive)
    alive = torch.logical_and(alive, torch.logical_not(killed))
    survived = torch.logical_and(mask, torch.logical_not(killed))
    tput = torch.where(
        survived[..., None],
        tput / torch.clamp(p_survive, min=1e-20)[..., None],
        tput,
    )
    return tput, alive, killed, rng


def bounce_step(
    scene: Scene, settings: RenderSettings, state: PathState, taps=None,
) -> PathState:
    """Advance every live lane by one path vertex
    (reference: NaiveVolPTsk_kernel.cuh:35-86):
      miss        → radiance += throughput * Le, lane dies;
      medium event→ throughput *= albedo, direction = HG sample;
      boundary    → GGX reflect/refract (weight = G1), or on an invalid
                    microfacet sample continue unchanged from the boundary;
      then Russian roulette on max(throughput).
    A list given as `taps` receives the flat density and albedo voxels the
    bounce reads and its per-lane state traffic (ops/familybody.family_bytes).
    """
    med = scene.medium
    o, d, tput, rad, alive, rng = (
        state.o, state.d, state.throughput, state.radiance, state.alive,
        state.rng,
    )

    n_rays = state.n_rays + torch.sum(alive.to(torch.float32))

    isect = aabb.aabb_intersect(med.box_min, med.box_max, o, d)
    if settings.boundary == "variable":
        # density-isosurface boundary + gradient shading normal
        # (reference: Medium.h:56-107)
        isect, rng = variable_boundary_adjust(
            scene, settings, o, d, isect, rng, alive, taps=taps
        )

    # --- miss: escape to the constant environment -------------------------
    miss = torch.logical_and(alive, torch.logical_not(isect.hit))
    rad = torch.where(miss[..., None], rad + tput * scene.le, rad)
    alive = torch.logical_and(alive, isect.hit)

    # --- free flight through the medium ----------------------------------
    in_medium = torch.logical_and(alive, isect.inside_volume)
    wres = woodcock.woodcock_track(
        med.density, med.box_min, med.box_max, med.scale, med.max_density,
        o, d, isect.dist, rng, in_medium, settings.interpolation,
        taps=taps,
    )
    rng = wres.rng
    scattered = wres.scattered
    boundary = torch.logical_and(alive, torch.logical_not(scattered))

    # --- boundary event: GGX rough dielectric ----------------------------
    o_bound = o + d * isect.dist[..., None]
    o_boundary_out, d_boundary_out, t_boundary, rng = boundary_event(
        scene, settings, isect.normal, o_bound, d, tput, rng, boundary
    )

    # --- medium event: absorb into albedo, HG scatter --------------------
    o_scat = o + d * wres.t[..., None] - d * EPSILON
    albedo = sample_albedo(scene, o_scat, settings)
    d_scat, rng = phase.sample_phase(d, med.g, rng, active=scattered)

    sc, bd = scattered[..., None], boundary[..., None]
    o = torch.where(sc, o_scat, torch.where(bd, o_boundary_out, o))
    d = torch.where(sc, d_scat, torch.where(bd, d_boundary_out, d))
    tput = torch.where(sc, tput * albedo, torch.where(bd, t_boundary, tput))

    # --- Russian roulette (reference: NaiveVolPTsk_kernel.cuh:75-84) -----
    rr_lanes = alive
    if settings.russian_roulette:
        tput, alive, _, rng = russian_roulette(tput, alive, rng, alive)

    new = PathState(
        o=o, d=d, throughput=tput, radiance=rad, alive=alive, rng=rng,
        n_rays=n_rays,
    )
    if taps is not None:
        # the lanes whose bounce reads each field before it writes it
        none = torch.zeros_like(state.alive)
        ggx_on = settings.bsdf_kind == "ggx"
        p01 = aabb.aabb_transform(med.box_min, med.box_max, o_scat)
        reads = {
            "alive": torch.ones_like(state.alive), "o": state.alive,
            "d": state.alive, "radiance": miss,
            "throughput": (miss | scattered | (boundary if ggx_on else none)
                           | (rr_lanes if settings.russian_roulette
                              else none)),
        }
        taps += [("albedo", tap_voxels(med.albedo, p01,
                                       settings.interpolation)[scattered]),
                 ("state", stages.lane_traffic(state, new, reads,
                                               familybody.PATH_FIELDS))]
    return new


def trace(
    scene: Scene, settings: RenderSettings, state: PathState
) -> PathState:
    """Run lanes to extinction, at most max_path_length bounces
    (reference: Config.h PathTracingConfig); with Russian roulette on,
    lanes die long before it."""
    bounce = 0
    while bounce < settings.max_path_length and bool(torch.any(state.alive)):
        state = bounce_step(scene, settings, state)
        bounce += 1
    return state


def initial_state(o, d, rng) -> PathState:
    n = o.shape[:-1]
    return PathState(
        o=o,
        d=d,
        throughput=torch.ones(n + (3,), dtype=torch.float32, device=o.device),
        radiance=torch.zeros(n + (3,), dtype=torch.float32, device=o.device),
        alive=torch.ones(n, dtype=torch.bool, device=o.device),
        rng=rng,
        n_rays=torch.zeros((), dtype=torch.float32, device=o.device),
    )
