"""Scene loading dispatch (reference: ConfigParser::createConfig's scene-type
selection, ConfigParser.cpp:99-115, with extension auto-detection).

Port of cudavolumerenderer_tpu/scene/loader.py: Mitsuba XML, RAW,
MHD/MHA, VDB (the native reader) and NPZ scenes.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from ..config import Config, SceneType
from ..ops.camera import Camera
from .mhd import load_mhd_scene
from .raw_builder import load_raw_scene
from .types import Scene
from .vdb import load_npz_scene, load_vdb_scene
from .xml_builder import load_xml_scene


def load_scene(config: Config, device="cuda") -> Tuple[Scene, Camera]:
    """The scene and camera of `config.scene_file` on `device` (the card
    unless the caller passes device="cpu"; no fallback)."""
    if config.scene_file is None:
        raise ValueError("no scene file provided")
    stype = config.scene_type
    if stype == SceneType.AUTO:
        stype = SceneType.detect(config.scene_file)
    if stype == SceneType.MITSUBA_XML:
        scene, camera = load_xml_scene(config.scene_file, device=device)
    elif stype == SceneType.RAW:
        scene, camera = load_raw_scene(config.scene_file, device=device)
    elif stype == SceneType.MHD:
        scene, camera = load_mhd_scene(config.scene_file, device=device)
    elif stype == SceneType.VDB:
        scene, camera = load_vdb_scene(config.scene_file, device=device)
    elif stype == SceneType.NPZ:
        scene, camera = load_npz_scene(config.scene_file, device=device)
    else:
        raise ValueError(f"unhandled scene type {stype}")

    w, h = config.resolution
    camera = override_resolution(camera, w, h)
    if not config.settings.mitsuba_comparable:
        # non-MITSUBA_COMPARABLE handedness: negate the camera's right
        # basis column (reference: Camera.h:30-34)
        inv_view = camera.inv_view.clone()
        inv_view[:, 0] = -inv_view[:, 0]
        camera = camera._replace(inv_view=inv_view)
    return scene, camera


def override_resolution(camera: Camera, w: int, h: int) -> Camera:
    """Re-derive ONLY the fov aspect for a resolution override
    (reference: ConfigParser.cpp:136-151 + Camera::setResolution); the
    pose is preserved."""
    fov_x = math.degrees(2.0 * math.atan(float(camera.raster_to_view[0])))
    fov_y = (float(h) / float(w)) * fov_x
    r2v = np.array(
        [
            math.tan(fov_x * math.pi / 360.0),
            math.tan(fov_y * math.pi / 360.0),
        ],
        np.float32,
    )
    return camera._replace(
        raster_to_view=torch.tensor(r2v, device=camera.inv_view.device)
    )
