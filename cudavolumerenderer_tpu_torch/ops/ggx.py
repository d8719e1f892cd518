"""GGX rough-dielectric boundary BSDF, branchless and batched.

Port of cudavolumerenderer_tpu/ops/ggx.py (reference: GGX.h, Bsdf.h:17-30):
visible-normal sampling in both variants (the Mitsuba analytic fit used
under MITSUBA_COMPARABLE, GGX.h:85-181/288-292, and Heitz 2017,
GGX.h:186-209), dielectric Fresnel with transmitted cosine
(GGX.h:13-38), reflect/refract (GGX.h:40-50) and Smith G1 with projected
roughness (GGX.h:213-255).  Directions are in the local shading frame
(z = surface normal).  Every lane consumes exactly three uniforms.
"""

from __future__ import annotations

import torch

from ..constants import EPSILON, PI
from . import math3
from .rng import RngState, next_float, next_float2


def fresnel_dielectric(eta, ndotwi):
    """Full Fresnel for a dielectric; returns (F, ndotwt)
    (reference: GGX.h:13-38).  eta = int_ior / ext_ior."""
    eta = torch.as_tensor(eta, dtype=torch.float32, device=ndotwi.device)
    scale = torch.where(ndotwi > 0.0, 1.0 / eta, eta)
    sin_sqr = 1.0 - ndotwi * ndotwi
    ndotwt_sqr = 1.0 - sin_sqr * scale * scale

    tir = ndotwt_sqr <= 0.0
    abs_ndotwi = torch.abs(ndotwi)
    abs_ndotwt = math3.sqrt(torch.clamp(ndotwt_sqr, min=0.0))

    rs = (abs_ndotwi - eta * abs_ndotwt) / (abs_ndotwi + eta * abs_ndotwt)
    rp = (eta * abs_ndotwi - abs_ndotwt) / (eta * abs_ndotwi + abs_ndotwt)
    f = 0.5 * (rs * rs + rp * rp)
    ndotwt = torch.where(ndotwi > 0.0, -abs_ndotwt, abs_ndotwt)

    f = torch.where(tir, 1.0, f)
    ndotwt = torch.where(tir, 0.0, ndotwt)

    index_matched = eta == 1.0
    f = torch.where(index_matched, 0.0, f)
    ndotwt = torch.where(index_matched, -ndotwi, ndotwt)
    return f, ndotwt


def refract_dir(eta, ndotwi, ndotwt, wi, n):
    """Refracted direction (reference: GGX.h:45-50); eta flips when
    ndotwt < 0 (the ray enters the denser side)."""
    eta = torch.as_tensor(eta, dtype=torch.float32, device=wi.device)
    eta_used = torch.where(ndotwt < 0.0, 1.0 / eta, eta)
    return n * (ndotwi * eta_used + ndotwt)[..., None] - wi * eta_used[..., None]


def _sample_visible11(theta_i, s1, s2):
    """Slope sampling for alpha = 1 — Mitsuba's analytic fit
    (reference: GGX.h:85-181), with where-selects."""
    phi = 2.0 * PI * s2
    r_special = math3.sqrt(
        torch.clamp(s1 / torch.clamp(1.0 - s1, min=1e-20), min=0.0)
    )
    special_x = r_special * torch.cos(phi)
    special_y = r_special * torch.sin(phi)
    is_special = theta_i < 1e-4

    tan_theta = torch.tan(theta_i)
    safe_tan = torch.where(is_special, 1.0, tan_theta)  # no 0-div under mask
    a = 1.0 + safe_tan * safe_tan
    g1 = 2.0 / (1.0 + math3.sqrt(a))

    big_a = (2.0 * s1 / g1) - 1.0
    big_a = torch.where(
        torch.abs(big_a) == 1.0, big_a - torch.sign(big_a) * EPSILON, big_a
    )
    tmp = 1.0 / (big_a * big_a - 1.0)
    b = safe_tan
    d = math3.sqrt(
        torch.clamp(
            (b * b * tmp * tmp) - ((big_a * big_a - b * b) * tmp), min=0.0
        )
    )
    slope_x_1 = b * tmp - d
    slope_x_2 = b * tmp + d
    use_1 = torch.logical_or(big_a < 0.0, slope_x_2 > 1.0 / safe_tan)
    slope_x = torch.where(use_1, slope_x_1, slope_x_2)

    s_sign = torch.where(s2 > 0.5, 1.0, -1.0)
    sy = torch.where(s2 > 0.5, 2.0 * (s2 - 0.5), 2.0 * (0.5 - s2))
    z = (
        sy * (sy * (sy * (-0.365728915865723) + 0.790235037209296)
              - 0.424965825137544)
        + 0.000152998850436920
    ) / (
        sy * (sy * (sy * (sy * 0.169507819808272 - 0.397203533833404)
                    - 0.232500544458471) + 1.0)
        - 0.539825872510702
    )
    slope_y = s_sign * z * math3.sqrt(1.0 + slope_x * slope_x)

    slope_x = torch.where(is_special, special_x, slope_x)
    slope_y = torch.where(is_special, special_y, slope_y)
    return slope_x, slope_y


def sample_vndf_mitsuba(wi, alpha, s1, s2):
    """Visible-normal sampling, Mitsuba variant (reference: GGX.h:143-181)."""
    ax, ay = alpha[..., 0], alpha[..., 1]
    wi_s = math3.normalize(
        torch.stack([ax * wi[..., 0], ay * wi[..., 1], wi[..., 2]], dim=-1)
    )
    wiz = torch.clamp(wi_s[..., 2], -1.0, 1.0)
    near_pole = wiz >= 0.999999
    theta = torch.where(near_pole, 0.0, torch.acos(wiz))
    phi = torch.where(near_pole, 0.0, torch.atan2(wi_s[..., 1], wi_s[..., 0]))
    sin_phi, cos_phi = torch.sin(phi), torch.cos(phi)

    sx, sy = _sample_visible11(theta, s1, s2)
    rx = cos_phi * sx - sin_phi * sy
    ry = sin_phi * sx + cos_phi * sy
    rx = rx * ax
    ry = ry * ay
    inv_norm = 1.0 / math3.sqrt(rx * rx + ry * ry + 1.0)
    return torch.stack([-rx * inv_norm, -ry * inv_norm, inv_norm], dim=-1)


def sample_vndf_heitz(wi, alpha, s1, s2):
    """Visible-normal sampling, Heitz 2017 variant (reference:
    GGX.h:186-209).  The tangent basis comes from the *unstretched* wi,
    as in the reference."""
    ax, ay = alpha[..., 0], alpha[..., 1]
    stretched = math3.normalize(
        torch.stack([wi[..., 0] * ax, wi[..., 1] * ay, wi[..., 2]], dim=-1)
    )
    z_axis = math3.vec3(0.0, 0.0, 1.0, device=wi.device).expand(wi.shape)
    t1_generic = math3.normalize(math3.cross(wi, z_axis))
    x_axis = math3.vec3(1.0, 0.0, 0.0, device=wi.device).expand(wi.shape)
    t1 = torch.where((wi[..., 2] < 0.9999)[..., None], t1_generic, x_axis)
    t2 = math3.cross(t1, wi)

    a = 1.0 / (1.0 + wi[..., 2])
    r = math3.sqrt(s1)
    lower = s2 < a
    phi = torch.where(
        lower,
        s2 / torch.clamp(a, min=1e-12) * PI,
        PI + (s2 - a) / torch.clamp(1.0 - a, min=1e-12) * PI,
    )
    p1 = r * torch.cos(phi)
    p2 = r * torch.sin(phi) * torch.where(lower, 1.0, wi[..., 2])
    pz = math3.sqrt(torch.clamp(1.0 - p1 * p1 - p2 * p2, min=0.0))
    n = p1[..., None] * t1 + p2[..., None] * t2 + pz[..., None] * stretched
    return math3.normalize(
        torch.stack(
            [ax * n[..., 0], ay * n[..., 1], torch.clamp(n[..., 2], min=0.0)],
            dim=-1,
        )
    )


def project_roughness(v, alpha):
    """Roughness projected on direction v (reference: GGX.h:214-227)."""
    ax, ay = alpha[..., 0], alpha[..., 1]
    vz = v[..., 2]
    inv_sin2 = 1.0 / torch.clamp(1.0 - vz * vz, min=1e-20)
    cos_phi2 = v[..., 0] * v[..., 0] * inv_sin2
    sin_phi2 = v[..., 1] * v[..., 1] * inv_sin2
    projected = math3.sqrt(cos_phi2 * ax * ax + sin_phi2 * ay * ay)
    isotropic_or_degenerate = torch.logical_or(
        ax == ay, (1.0 - vz * vz) <= 0.0
    )
    return torch.where(isotropic_or_degenerate, ax, projected)


def smith_g1(alpha, v, m):
    """Smith masking term G1 (reference: GGX.h:229-255) with the
    reference's degenerate-case ordering."""
    vz = v[..., 2]
    back = math3.dot(v, m) * vz <= 0.0
    temp = 1.0 - vz * vz
    degenerate = temp <= 0.0
    tan_v = torch.abs(
        math3.sqrt(torch.clamp(temp, min=0.0)) / torch.where(vz == 0.0, 1.0, vz)
    )
    proj = project_roughness(v, alpha)
    root = proj * tan_v
    g = 2.0 / (1.0 + math3.sqrt(1.0 + root * root))
    g = torch.where(tan_v == 0.0, 1.0, g)
    g = torch.where(degenerate, 0.0, g)
    g = torch.where(back, 0.0, g)
    return g


def ggx_sample(
    roughness: torch.Tensor,  # (..., 2) or (2,)
    eta,  # int_ior / ext_ior
    wi: torch.Tensor,  # (..., 3) local frame, z = normal
    rng: RngState,
    active=None,
    mitsuba_comparable: bool = True,
):
    """Sample the rough dielectric (reference: GGX.h:265-326).

    Returns (wo, weight, valid, rng).  weight is G1(wo) for valid samples
    and 0 otherwise; invalid lanes must be left unchanged by the caller,
    as the reference kernels do."""
    alpha = torch.as_tensor(
        roughness, dtype=torch.float32, device=wi.device
    ).expand(wi.shape[:-1] + (2,))
    ndotwi = wi[..., 2]
    sign = torch.where(ndotwi >= 0.0, 1.0, -1.0)

    s1, s2, rng = next_float2(rng, active)
    sample_vndf = sample_vndf_mitsuba if mitsuba_comparable else sample_vndf_heitz
    wh = sample_vndf(sign[..., None] * wi, alpha, s1, s2)

    whdotwi = math3.dot(wh, wi)
    f, whdotwt = fresnel_dielectric(eta, whdotwi)

    u_choice, rng = next_float(rng, active)
    choose_reflect = u_choice <= f

    wo_reflect = math3.reflect_about(whdotwi, wi, wh)
    reflect_valid = ndotwi * wo_reflect[..., 2] > 0.0

    wo_refract = refract_dir(eta, whdotwi, whdotwt, wi, wh)
    refract_valid = torch.logical_and(
        whdotwt != 0.0, ndotwi * wo_refract[..., 2] < 0.0
    )

    wo = torch.where(choose_reflect[..., None], wo_reflect, wo_refract)
    valid = torch.where(choose_reflect, reflect_valid, refract_valid)
    valid = torch.logical_and(valid, ndotwi != 0.0)

    weight = torch.where(valid, smith_g1(alpha, wo, wh), 0.0)
    return wo, weight, valid, rng
