"""Henyey–Greenstein phase function: pdf and importance sampling, batched.

Port of cudavolumerenderer_tpu/ops/phase.py (reference: HG.h:26-63,
Volume.h:19-29); the isotropic |g| < eps branch is a where.
"""

from __future__ import annotations

import torch

from ..constants import EPSILON, INV_FOURPI, TWO_PI
from . import math3
from .rng import RngState, next_float2


def phase_hg(cos_theta: torch.Tensor, g) -> torch.Tensor:
    """HG phase value / pdf (reference: HG.h:26-35)."""
    g = torch.as_tensor(g, dtype=torch.float32, device=cos_theta.device)
    denom = 1.0 + g * g - 2.0 * g * cos_theta
    return INV_FOURPI * (1.0 - g * g) / torch.pow(denom, 1.5)


def pdf_hg(wi: torch.Tensor, wo: torch.Tensor, g) -> torch.Tensor:
    return phase_hg(math3.dot(wi, wo), g)


def importance_sample_hg(d: torch.Tensor, g, e1, e2) -> torch.Tensor:
    """Sample a scattered direction about ``d`` (reference: HG.h:46-63).
    Uses 2*g where the reference divides by 2*fabsf(g) (HG.h:53), as the
    JAX package does: the reference only instantiates g = 0."""
    g = torch.as_tensor(g, dtype=torch.float32, device=e1.device).expand(
        e1.shape
    )
    sqr_term = (1.0 - g * g) / torch.clamp(1.0 - g + 2.0 * g * e1, min=1e-12)
    g_safe = torch.where(torch.abs(g) > 1e-12, g, 1.0)
    cos_aniso = (1.0 + g * g - sqr_term * sqr_term) / (2.0 * g_safe)
    cos_iso = 1.0 - 2.0 * e1
    cos_theta = torch.where(torch.abs(g) > EPSILON, cos_aniso, cos_iso)
    cos_theta = torch.clamp(cos_theta, -1.0, 1.0)

    sin_theta = math3.sqrt(torch.clamp(1.0 - cos_theta * cos_theta, min=0.0))
    phi = TWO_PI * e2

    v1, v2 = math3.local_basis(d)
    return math3.spherical_direction(sin_theta, cos_theta, phi, v1, v2, d)


def sample_phase(d: torch.Tensor, g, rng: RngState, active=None):
    """Draw (e1, e2) and scatter; matches HG::sample draw order
    (reference: Volume.h:24-28)."""
    e1, e2, rng = next_float2(rng, active)
    return importance_sample_hg(d, g, e1, e2), rng
