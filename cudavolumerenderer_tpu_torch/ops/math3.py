"""Small-vector math on batched (..., 3) tensors.

Port of cudavolumerenderer_tpu/ops/math3.py: the reference's float3
helpers and local-frame utilities (reference: CVRMath.h, HG.h:11-24) as
broadcasting torch ops over a whole ray wavefront.
"""

from __future__ import annotations

import torch

from ..constants import EPSILON


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded square root, the only one the port calls.

    On some hosts torch's CPU float32 sqrt is 1 ulp off for a share of
    inputs (it is not correctly rounded), while XLA and the card round
    correctly; near grazing angles GGX's tan(acos(.)) grows that ulp
    until a path's fate flips.  A float64 sqrt rounded to float32 is
    exact (float64 has more than 2 * 24 + 2 bits), so CPU float32 takes
    that route."""
    if x.dtype == torch.float32 and x.device.type == "cpu":
        return torch.sqrt(x.double()).float()
    return torch.sqrt(x)


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.sum(a * b, dim=-1)


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack(
        [ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], dim=-1
    )


def norm(a: torch.Tensor) -> torch.Tensor:
    return sqrt(torch.sum(a * a, dim=-1))


def normalize(a: torch.Tensor) -> torch.Tensor:
    return a / torch.clamp(norm(a), min=1e-20)[..., None]


def vec3(x, y, z, device=None) -> torch.Tensor:
    """Stack three broadcastable components into (..., 3) float32."""
    parts = [
        torch.as_tensor(c, dtype=torch.float32, device=device)
        for c in (x, y, z)
    ]
    return torch.stack(torch.broadcast_tensors(*parts), dim=-1)


def max3(a: torch.Tensor) -> torch.Tensor:
    """Componentwise max over the last axis (reference: CVRMath.h fmaxf3)."""
    return torch.amax(a, dim=-1)


def frame_from_z(z: torch.Tensor):
    """Orthonormal frame (x, y, z) around normal ``z``
    (reference: Frame::setFromZ, CVRMath.h:68-74)."""
    zn = normalize(z)
    helper_is_y = torch.abs(zn[..., 0]) > 0.99
    helper = torch.where(
        helper_is_y[..., None],
        vec3(0.0, 1.0, 0.0, device=z.device),
        vec3(1.0, 0.0, 0.0, device=z.device),
    )
    y = normalize(cross(zn, helper))
    x = cross(y, zn)
    return x, y, zn


def to_local(t, b, n, v):
    """World → local (z = n) coordinates."""
    return torch.stack([dot(v, t), dot(v, b), dot(v, n)], dim=-1)


def to_world(t, b, n, v):
    """Local (z = n) → world coordinates."""
    return v[..., 0:1] * t + v[..., 1:2] * b + v[..., 2:3] * n


def local_basis(d: torch.Tensor):
    """Basis (v1, v2) around direction ``d`` (reference: HG.h:11-17),
    with an epsilon guard for the (x, z) ≈ 0 pole."""
    dx, dz = d[..., 0], d[..., 2]
    inv_n1 = 1.0 / sqrt(torch.clamp(dx * dx + dz * dz, min=1e-12))
    v1 = torch.stack([dz * inv_n1, torch.zeros_like(dx), -dx * inv_n1], dim=-1)
    v2 = cross(d, v1)
    return v1, v2


def spherical_direction(sin_theta, cos_theta, phi, x, y, z):
    """Direction from spherical coords in basis (x, y, z)
    (reference: HG.h:19-24)."""
    return (
        (sin_theta * torch.cos(phi))[..., None] * x
        + (sin_theta * torch.sin(phi))[..., None] * y
        + cos_theta[..., None] * z
    )


def reflect_about(ndotwi, wi, wh):
    """Mirror ``wi`` about half-vector ``wh`` (reference: GGX.h:40-43)."""
    return 2.0 * ndotwi[..., None] * wh - wi


def offset_ray(o, d, eps: float = EPSILON):
    """Nudge origin along direction to escape self-intersection."""
    return o + d * eps
