"""Mitsuba XML scene builder.

Port of cudavolumerenderer_tpu/scene/xml_builder.py (reference:
XmlSceneBuilder.h:39-152): find the heterogeneous medium's density and
albedo gridvolumes and its scale, load the .vol files, and set up a
perspective camera from the sensor's fov and hdrfilm size.
"""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET
from typing import Tuple

import numpy as np

from ..ops.camera import Camera, make_camera
from .types import Scene, loader_device, make_medium, make_scene
from .vol import read_vol


def _find_child_by_attr(parent, tag, attr, value):
    for child in parent.iter(tag):
        if child.get(attr) == value:
            return child
    return None


def load_xml_scene(path: str, device="cuda") -> Tuple[Scene, Camera]:
    device = loader_device(device)
    root = ET.parse(path).getroot()
    basedir = os.path.dirname(os.path.abspath(path))

    medium_node = _find_child_by_attr(root, "medium", "type", "heterogeneous")
    if medium_node is None:
        raise ValueError(f"{path!r}: no heterogeneous medium found")

    def vol_path(name):
        node = _find_child_by_attr(medium_node, "volume", "name", name)
        if node is None or node.get("type") != "gridvolume":
            raise ValueError(f"{path!r}: missing {name} gridvolume")
        return os.path.join(basedir, node.find("string").get("value"))

    scale_node = _find_child_by_attr(medium_node, "float", "name", "scale")
    if scale_node is None:
        raise ValueError(f"{path!r}: medium has no scale")
    scale = float(scale_node.get("value"))

    density = read_vol(vol_path("density"))
    albedo = read_vol(vol_path("albedo"))

    # max_density as the reference computes it: max of per-voxel
    # min(1, rho) (XmlSceneBuilder.h vol2Rawf) — the majorant is clamped
    # to 1 even if the data exceeds it.
    max_density = float(np.minimum(density.data, 1.0).max())

    medium = make_medium(
        density.data, albedo.data, box_min=density.box_min,
        box_max=density.box_max, scale=scale, max_density=max_density,
        device=device,
    )

    # Camera (XmlSceneBuilder.h:122-152): perspective sensor fov (degrees)
    # + hdrfilm width/height, defaults 400x400 / 45°.
    width, height, fov = 400, 400, 45.0
    sensor = _find_child_by_attr(root, "sensor", "type", "perspective")
    if sensor is not None:
        fov_node = _find_child_by_attr(sensor, "float", "name", "fov")
        if fov_node is not None:
            fov = float(fov_node.get("value"))
        film = _find_child_by_attr(sensor, "film", "type", "hdrfilm")
        if film is not None:
            w = _find_child_by_attr(film, "integer", "name", "width")
            h = _find_child_by_attr(film, "integer", "name", "height")
            if w is not None and h is not None:
                width, height = int(w.get("value")), int(h.get("value"))
    return make_scene(medium), make_camera(width, height, fov, device=device)
