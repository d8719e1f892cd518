"""Interactive camera controller: rotate / zoom / pan with
accumulation-reset semantics.

Port of cudavolumerenderer_tpu/ops/camera_controller.py: the same numpy
quaternion dynamics; `camera()` builds the port's torch Camera.

The scripted (offline) re-expression of the reference's mouse camera
(reference: implementation/src/Camera.h:74-122 lazyRotateAroundTheCenterBy
/ lazyMoveBy / lazyUpdate, implementation/src/InteractiveRenderer.h:241-282
InputController mouse callbacks + dirty-flag → reset()).  The state is
exactly the reference's: a quaternion `orientation` composed as
q_pitch * q * q_yaw per rotate event (an orbit around the volume center),
and a lazily accumulated view-space `translation` with the 5x zoom
multiplier.  The render camera is rebuilt as

    inv_view = [ R | R @ (-translation) ]      R = mat(orientation)

which is the row-major reading of the reference's
mat4_cast(orientation) * translate(-translation) upload
(CudaVolPath.cpp:66-85 transposes the column-major GL matrix into the
3x4 rows the kernels consume).  Rotations therefore move the camera
position R@(-t) on a sphere around the origin — the
"rotate around the center" behavior.

Two deliberate deviations from the reference source, both initial-state
consistency fixes (the dynamics are identical):

  * the MITSUBA x-flip is absorbed into the *initial* orientation
    (quat of diag(1,-1,-1), i.e. a pi rotation about x) instead of
    re-flipping column 0 on every lazyUpdate — re-flipping a matrix
    whose orientation quaternion already encodes the flip would negate
    the determinant on the first motion event;
  * look_at initializes (orientation, translation) so that the composed
    update reproduces the look-at pose exactly (the reference resets
    orientation to identity and stores the matrix directly, so its
    first post-lookAt motion event snaps to an unrelated pose).

Events mirror InteractiveRenderer.h:251-274: rotate uses pixel deltas
normalized by resolution times rotation_velocity (1.0); zoom uses
max(dx/res_x, dy/res_y); pan uses (dx/res_x, dy/res_y).  Every event
sets the dirty flag; the replay driver (cli.run_interactive) calls
consume_dirty() and resets the progressive accumulation exactly like
reset() → initRendering() (InteractiveRenderer.h:102,314-317).
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from ..scene.types import loader_device
from .camera import Camera, make_camera

ROTATION_VELOCITY = 1.0  # InteractiveRenderer.h:219
ZOOM_SPEED_MULTIPLIER = 5.0  # Camera.h:82


def quat_mul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Hamilton product, (w, x, y, z) layout."""
    aw, ax, ay, az = a
    bw, bx, by, bz = b
    return np.array(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        np.float64,
    )


def quat_from_axis_angle(axis, angle: float) -> np.ndarray:
    axis = np.asarray(axis, np.float64)
    axis = axis / np.linalg.norm(axis)
    h = 0.5 * angle
    return np.concatenate([[math.cos(h)], math.sin(h) * axis])


def quat_to_mat(q: np.ndarray) -> np.ndarray:
    """Standard 3x3 rotation matrix (M @ v rotates v by q)."""
    w, x, y, z = q / np.linalg.norm(q)
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ],
        np.float64,
    )


def quat_from_mat(m: np.ndarray) -> np.ndarray:
    """Quaternion of a proper rotation matrix (Shepperd's method)."""
    m = np.asarray(m, np.float64)
    t = np.trace(m)
    if t > 0:
        s = math.sqrt(t + 1.0) * 2
        return np.array(
            [0.25 * s, (m[2, 1] - m[1, 2]) / s, (m[0, 2] - m[2, 0]) / s,
             (m[1, 0] - m[0, 1]) / s]
        )
    i = int(np.argmax(np.diag(m)))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = math.sqrt(max(m[i, i] - m[j, j] - m[k, k] + 1.0, 0.0)) * 2
    q = np.zeros(4)
    q[0] = (m[k, j] - m[j, k]) / s
    q[1 + i] = 0.25 * s
    q[1 + j] = (m[j, i] + m[i, j]) / s
    q[1 + k] = (m[k, i] + m[i, k]) / s
    return q


class CameraController:
    """Scripted-event camera with the reference's orbit dynamics."""

    def __init__(
        self,
        res_x: int = 400,
        res_y: int = 400,
        fov_x_deg: float = 0.7,
        position: Tuple[float, float, float] = (0.0, 0.0, 100.0),
        mitsuba_comparable: bool = True,
    ):
        self.res = (int(res_x), int(res_y))
        self.fov_x_deg = float(fov_x_deg)
        # default pose (Camera.h:30-42): R = diag(1,-1,-1) (mitsuba) is
        # a pi rotation about x; position p comes from R @ (-t).  Both
        # values of mitsuba_comparable start from this pose, as in the
        # JAX package
        r0 = np.diag([1.0, -1.0, -1.0])
        self.orientation = quat_from_mat(r0)
        self.translation = -(r0.T @ np.asarray(position, np.float64))
        self.dirty = False

    # -- events (InteractiveRenderer.h mouse callbacks) -------------------
    def rotate(self, dx_px: float, dy_px: float) -> None:
        """Left drag: orbit around the center (Camera.h:74-78)."""
        dtheta = ROTATION_VELOCITY * dy_px / self.res[1]
        dphi = ROTATION_VELOCITY * dx_px / self.res[0]
        q_pitch = quat_from_axis_angle((1.0, 0.0, 0.0), dtheta)
        q_yaw = quat_from_axis_angle((0.0, 1.0, 0.0), dphi)
        q = quat_mul(quat_mul(q_pitch, self.orientation), q_yaw)
        self.orientation = q / np.linalg.norm(q)
        self.dirty = True

    def zoom(self, dx_px: float, dy_px: float) -> None:
        """Right drag (InteractiveRenderer.h:262-265)."""
        dz = max(dx_px / self.res[0], dy_px / self.res[1])
        self._move(0.0, 0.0, dz)

    def pan(self, dx_px: float, dy_px: float) -> None:
        """Middle drag (InteractiveRenderer.h:266-271)."""
        self._move(dx_px / self.res[0], dy_px / self.res[1], 0.0)

    def _move(self, x: float, y: float, z: float) -> None:
        self.translation = self.translation + np.array(
            [x, y, z * ZOOM_SPEED_MULTIPLIER], np.float64
        )
        self.dirty = True

    def look_at(self, eye, center, up) -> None:
        """Jump to a look-at pose; subsequent events compose with it."""
        eye = np.asarray(eye, np.float64)
        forward = np.asarray(center, np.float64) - eye
        forward = forward / np.linalg.norm(forward)
        right = np.cross(forward, np.asarray(up, np.float64))
        right = right / np.linalg.norm(right)
        new_up = np.cross(right, forward)
        # inv_view's linear part carries (right, -new_up, forward) as
        # COLUMNS (ops.camera.make_camera_look_at builds it row-wise
        # from their components), and camera() emits R = mat(q) as that
        # linear part — so the orientation matrix is the transpose of
        # the row stack.  translation solves R @ (-t) = eye.
        rot = np.stack([right, -new_up, forward]).T
        self.orientation = quat_from_mat(rot)
        self.translation = -(rot.T @ eye)
        self.dirty = True

    def consume_dirty(self) -> bool:
        """True exactly once per batch of motion events (the dirty-flag
        handshake that triggers the accumulation reset)."""
        was = self.dirty
        self.dirty = False
        return was

    # -- state ------------------------------------------------------------
    @property
    def position(self) -> np.ndarray:
        return quat_to_mat(self.orientation) @ (-self.translation)

    def camera(self, device="cuda") -> Camera:
        """Render camera for the current pose, on `device` (the card
        unless the caller passes device="cpu")."""
        device = loader_device(device)
        rot = quat_to_mat(self.orientation)
        inv_view = np.concatenate(
            [rot, (rot @ (-self.translation))[:, None]], axis=1
        ).astype(np.float32)
        base = make_camera(
            self.res[0], self.res[1], self.fov_x_deg, device=device
        )
        return Camera(
            inv_view=torch.tensor(inv_view, device=device),
            raster_to_view=base.raster_to_view,
        )


def parse_camera_path(text: str):
    """Parse a camera-path script: one event per line.

    rotate DX DY | zoom DX DY | pan DX DY | lookat ex ey ez cx cy cz
    | render N (run N progressive iterations, then dump a frame).
    '#' comments and blank lines ignored."""
    events = []
    for ln, raw in enumerate(text.splitlines(), 1):
        line = raw.split("#", 1)[0].strip()
        if not line:
            continue
        parts = line.split()
        op, args = parts[0].lower(), [float(p) for p in parts[1:]]
        if op in ("rotate", "zoom", "pan") and len(args) == 2:
            events.append((op, args))
        elif op == "lookat" and len(args) == 6:
            events.append((op, args))
        elif op == "render" and len(args) == 1:
            events.append((op, [int(args[0])]))
        else:
            raise ValueError(f"camera path line {ln}: bad event {raw!r}")
    return events
