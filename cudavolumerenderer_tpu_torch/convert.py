"""Carry a scene, a camera, the differentiable path's specs and Adam's
state across from the JAX package.

The functions take plain numpy arrays (the leaves of the JAX `Scene`,
`Camera` and optax state, read with np.asarray) or the JAX package's spec
dataclasses read field by field, so this module needs no jax.  The
albedo's affine fit is taken as given and never refit: given the same
arrays, both packages render the same scene.  The grids of the inverse
problem cross as numpy arrays.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .models.differentiable import CameraSpec, SceneSpec
from .models.inverse import AdamState
from .ops.camera import Camera
from .ops.grid import Grid
from .scene.types import Bsdf, Medium, Scene


def _t(x, device) -> torch.Tensor:
    return torch.tensor(np.asarray(x, np.float32), device=device)


def scene_from_arrays(
    density, albedo, albedo_affine, box_min, box_max, scale, max_density,
    g, roughness, eta, le, device="cpu",
) -> Scene:
    """Scene from the JAX Scene's leaves: density (Z, Y, X), albedo
    (Z, Y, X, 4) or (1, 1, 1, C), albedo_affine (2, 3) or None, box
    corners (3,), scalars scale / max_density / g / eta, roughness (2,),
    environment radiance le (3,)."""
    medium = Medium(
        density=Grid(_t(density, device)),
        albedo=Grid(_t(albedo, device)),
        box_min=_t(box_min, device),
        box_max=_t(box_max, device),
        scale=_t(scale, device),
        max_density=_t(max_density, device),
        g=_t(g, device),
        albedo_affine=None if albedo_affine is None else _t(albedo_affine, device),
    )
    return Scene(
        medium=medium,
        bsdf=Bsdf(roughness=_t(roughness, device), eta=_t(eta, device)),
        le=_t(le, device),
    )


def camera_from_arrays(inv_view, raster_to_view, device="cpu") -> Camera:
    """Camera from the JAX Camera's (3, 4) inv_view and (2,)
    raster_to_view."""
    return Camera(
        inv_view=_t(inv_view, device),
        raster_to_view=_t(raster_to_view, device),
    )


def _spec_fields(cls, spec):
    return cls(**{f.name: getattr(spec, f.name)
                  for f in dataclasses.fields(cls)})


def scene_spec_from_jax(spec) -> SceneSpec:
    """The port's SceneSpec with the fields of the JAX package's."""
    return _spec_fields(SceneSpec, spec)


def camera_spec_from_jax(spec) -> CameraSpec:
    """The port's CameraSpec with the fields of the JAX package's."""
    return _spec_fields(CameraSpec, spec)


def adam_state_from_optax_leaves(leaves, device="cpu") -> AdamState:
    """optax.adam's state leaves (jax.tree_util.tree_leaves order: count,
    mu per parameter, nu per parameter) as numpy arrays → the AdamState
    that models.inverse.make_adam resumes torch.optim.Adam from."""
    if len(leaves) % 2 != 1:
        raise ValueError(f"{len(leaves)} Adam leaves: expected count + 2k")
    k = (len(leaves) - 1) // 2
    moments = [_t(x, device) for x in leaves[1:]]
    return AdamState(int(np.asarray(leaves[0])), tuple(moments[:k]),
                     tuple(moments[k:]))
