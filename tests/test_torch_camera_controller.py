"""The port's camera controller (ops/camera_controller.py) against the JAX
package's: the quaternion helpers, every controller event and the
cameras it builds (allclose at 1e-6), the camera-path parser, and the
CLI's camera-path replay resetting the progressive accumulation."""

import numpy as np
import pytest
import torch

from cudavolumerenderer_tpu.ops import camera_controller as jcc
from cudavolumerenderer_tpu_torch import cli
from cudavolumerenderer_tpu_torch.ops import camera_controller as tcc
from cudavolumerenderer_tpu_torch.ops.camera import (
    generate_rays,
    make_camera,
    make_camera_look_at,
)
from cudavolumerenderer_tpu_torch.ops.rng import make_rng
from cudavolumerenderer_tpu_torch.scene import procedural

TOL = dict(rtol=1e-6, atol=1e-6)


def unit_quats(seed, n=20):
    rs = np.random.RandomState(seed)
    q = rs.randn(n, 4)
    return q / np.linalg.norm(q, axis=1, keepdims=True)


def test_quat_helpers_equal_jax():
    qs = unit_quats(0)
    for a, b in zip(qs, qs[::-1]):
        np.testing.assert_allclose(tcc.quat_mul(a, b), jcc.quat_mul(a, b), **TOL)
        m = tcc.quat_to_mat(a)
        np.testing.assert_allclose(m, jcc.quat_to_mat(a), **TOL)
        np.testing.assert_allclose(tcc.quat_from_mat(m), jcc.quat_from_mat(m),
                                   **TOL)
        # proper rotation, and q2 is the same rotation (q or -q)
        np.testing.assert_allclose(m @ m.T, np.eye(3), atol=1e-12)
        np.testing.assert_allclose(tcc.quat_to_mat(tcc.quat_from_mat(m)), m,
                                   atol=1e-10)
    np.testing.assert_allclose(
        tcc.quat_from_axis_angle((1.0, 2.0, 3.0), 0.7),
        jcc.quat_from_axis_angle((1.0, 2.0, 3.0), 0.7), **TOL)


def assert_same(t, j):
    np.testing.assert_allclose(t.orientation, j.orientation, **TOL)
    np.testing.assert_allclose(t.translation, j.translation, **TOL)
    np.testing.assert_allclose(t.position, j.position, **TOL)
    tc, jc = t.camera(device="cpu"), j.camera()
    np.testing.assert_allclose(tc.inv_view.numpy(), np.asarray(jc.inv_view),
                               **TOL)
    np.testing.assert_array_equal(tc.raster_to_view.numpy(),
                                  np.asarray(jc.raster_to_view))
    assert t.dirty == j.dirty


EVENTS = [
    ("rotate", (40.0, 15.0)), ("zoom", (10.0, 0.0)), ("pan", (10.0, -20.0)),
    ("look_at", ((30.0, 40.0, 50.0), (0.0, 0.0, 0.0), (0.0, 1.0, 0.0))),
    ("rotate", (-25.0, 60.0)), ("zoom", (0.0, -7.0)),
]


@pytest.mark.parametrize("res", [(100, 100), (64, 32)])
def test_every_event_equals_jax(res):
    t = tcc.CameraController(*res, fov_x_deg=0.7)
    j = jcc.CameraController(*res, fov_x_deg=0.7)
    assert_same(t, j)
    for op, args in EVENTS:
        getattr(t, op)(*args)
        getattr(j, op)(*args)
        assert_same(t, j)
        assert t.consume_dirty() and j.consume_dirty()
        assert not t.consume_dirty()


def test_default_pose_and_look_at_match_cameras():
    ctl = tcc.CameraController(32, 32, fov_x_deg=0.7)
    torch.testing.assert_close(ctl.camera(device="cpu").inv_view,
                               make_camera(32, 32, 0.7, device="cpu").inv_view,
                               atol=1e-6, rtol=0)
    eye = (30.0, 40.0, 50.0)
    ctl.look_at(eye, (0.0, 0.0, 0.0), (0, 1, 0))
    ref = make_camera_look_at(eye, (0.0, 0.0, 0.0), (0, 1, 0), 32, 32, 0.7,
                              device="cpu")
    torch.testing.assert_close(ctl.camera(device="cpu").inv_view, ref.inv_view,
                               atol=1e-5, rtol=0)
    r0 = np.linalg.norm(ctl.position)
    ctl.rotate(25.0, 10.0)  # motion composes with the pose
    assert abs(np.linalg.norm(ctl.position) - r0) < 1e-6
    assert ctl.camera(device="cpu").inv_view.dtype == torch.float32


def test_rotated_camera_rays_aim_at_center():
    ctl = tcc.CameraController(9, 9)
    ctl.rotate(120.0, 60.0)
    rng = make_rng(1, torch.arange(1))
    o, d, _ = generate_rays(ctl.camera(device="cpu"),
                            torch.tensor([[4.0, 4.0]]), (9, 9),
                            rng, active=torch.ones(1, dtype=torch.bool))
    o, d = o[0].numpy(), d[0].numpy()
    np.testing.assert_allclose(o, ctl.position, atol=1e-4)
    assert np.dot(d, -o / np.linalg.norm(o)) > 0.999


def test_parse_camera_path_equals_jax():
    text = ("# demo\nrotate 10 5\nzoom 3 0\npan 1 2\n"
            "lookat 0 0 80 0 0 0\n\nrender 2  # two passes\n")
    assert tcc.parse_camera_path(text) == jcc.parse_camera_path(text)
    assert [e[0] for e in tcc.parse_camera_path(text)] == [
        "rotate", "zoom", "pan", "lookat", "render"]
    with pytest.raises(ValueError, match="line 1"):
        tcc.parse_camera_path("spin 1 2\n")


def test_cli_replay_resets_accumulation(tmp_path, capsys):
    """Motion events between renders reset the progressive accumulation
    (reference reset() semantics); one frame per render event."""
    raw = tmp_path / "blob.raw"
    procedural.write_raw_uchar(str(raw), procedural.blob_volume())
    script = tmp_path / "path.txt"
    script.write_text("render 2\nrotate 30 10\nrender 1\nzoom 5 0\nrender 1\n")
    out = tmp_path / "frame"
    rc = cli.main([str(raw), "--interactive", "1", "--camera-path",
                   str(script), "-i", "4", "-r", "8", "8", "-k", "naiveSK",
                   "-o", str(out), "--platform", "cpu"])
    assert rc == 0
    txt = capsys.readouterr().out
    assert txt.count("accumulation reset") == 2
    # frame 1 accumulated 2 iterations; frames 2-3 restarted at 1
    assert "path frame 1 dumped (2 it)" in txt
    assert "path frame 2 dumped (1 it)" in txt
    assert "path frame 3 dumped (1 it)" in txt
    for i in (1, 2, 3):
        assert (tmp_path / f"frame_path{i:04d}.png").exists()
