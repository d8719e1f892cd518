"""The port's parallel/ (torch.distributed) against the JAX package's
parallel/ (shard_map over the 8-device CPU mesh of tests/conftest.py).

One spawn of 2 and one of 4 gloo processes (tests/torch_shard_worker.py,
started together) render every case of the worker's CASES with the
port's render_sharded on the same numpy scene as JAX's render_sharded on
make_mesh(2) and make_mesh(4): naive, streaming, fastSK one- and
two-level, odd spp (5, 13) and pure remainder (3 < 4 ranks), the knobs
cascade_factor 1.25 / min_width 256, q4 packed tables, path ids that wrap
past 2^32, and the configuration the champion numbers run (q4, cascade
1.25) in multi-tile lane mode (four tiles, per-tile bases).  n_rays
exact everywhere.  Against the port's single-process render_tile with
the same total spp, images allclose at 1e-5 (naive, streaming) and 2e-5
(fastSK), tests/test_sharding.py's tolerances (the order of the float32
sum over ranks).  Against JAX, images allclose at JAX_TOL (1e-4), the
port's tolerance against JAX wherever the GGX boundary runs
(tests/test_torch_schedulers.py): XLA's transcendentals differ from
torch's in the last bits, which moves naive-wrap's image by 4.8e-5 even
op by op; the other cases agree to 2e-5.  fastSK one-level is held
against JAX's shards rendered op by op (jax.disable_jit): under XLA's CPU
jit one path of its render parts at an fma XLA contracts (ROADMAP, "XLA's
CPU jit"), 6 of 192 values off by 1.0 with n_rays equal, which the
jitted comparison of its rays still checks.

The 2-rank group also runs make_inverse_step (tests/test_sharding.py's
scene and optax.sgd(5.0) against torch.optim.SGD(lr=5.0)): the loss and
both grids after one step against JAX's make_inverse_step on
make_mesh(2), and three steps descending.
"""

import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.distributed as dist

import torch_shard_worker as worker
from cudavolumerenderer_tpu.models import fast as jfast
from cudavolumerenderer_tpu.models.differentiable import (
    CameraSpec as JCameraSpec,
    SceneSpec as JSceneSpec,
)
from cudavolumerenderer_tpu.ops.camera import make_camera
from cudavolumerenderer_tpu.parallel import mesh as jmesh
from cudavolumerenderer_tpu.parallel import shard as jshard
from cudavolumerenderer_tpu.scene import procedural
from cudavolumerenderer_tpu.scene.types import (
    RenderSettings,
    make_medium,
    make_scene,
)
from cudavolumerenderer_tpu_torch import convert
from cudavolumerenderer_tpu_torch.models import fast, naive, streaming
from cudavolumerenderer_tpu_torch.parallel import mesh as tmesh
from cudavolumerenderer_tpu_torch.parallel import shard as tshard
from cudavolumerenderer_tpu_torch.scene import types as ttypes
from test_torch_schedulers import JAX_TOL

WORKER = os.path.abspath(worker.__file__)
WORLDS = (2, 4)
#: seconds for a whole gloo group (the 4-rank one takes ~20 s here)
GROUP_TIMEOUT = 300
TARGET = float(np.exp(-10 * 0.3))  # tests/test_sharding.py's target radiance
#: cases held against JAX op by op (XLA's CPU jit moves a path)
EAGER = ("fast-one",)


def tol(name):
    """tests/test_sharding.py's tolerances: 1e-5 naive, 2e-5 fastSK."""
    t = 2e-5 if worker.CASES[name]["kernel"] == "fast" else 1e-5
    return dict(rtol=t, atol=t)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def jax_scene():
    """tests/test_sharding.py's small_scene and camera."""
    dens = procedural.blob_volume((8, 8, 8), n_blobs=3)
    albedo = np.stack([dens, 0.5 * np.ones_like(dens), 1.0 - dens], axis=-1)
    scene = make_scene(make_medium(dens, albedo, scale=10.0, max_density=1.0))
    return scene, make_camera(*worker.RES)


def scene_arrays(scene, camera) -> dict:
    m = scene.medium
    return dict(
        density=m.density.data, albedo=m.albedo.data,
        albedo_affine=m.albedo_affine, box_min=m.box_min, box_max=m.box_max,
        scale=m.scale, max_density=m.max_density, g=m.g,
        roughness=scene.bsdf.roughness, eta=scene.bsdf.eta, le=scene.le,
        inv_view=camera.inv_view, raster_to_view=camera.raster_to_view,
        target=np.full(worker.RES + (3,), TARGET, np.float32),
    )


@pytest.fixture(scope="module")
def groups(jax_scene, tmp_path_factory):
    """{world: rank 0's results} from the 2- and 4-rank groups, run at
    the same time."""
    tmp = tmp_path_factory.mktemp("gloo")
    scene_npz = str(tmp / "scene.npz")
    np.savez(scene_npz, **{k: np.asarray(v) for k, v in
                           scene_arrays(*jax_scene).items()})
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = {}
    for world in WORLDS:
        port = free_port()
        procs[world] = [subprocess.Popen(
            [sys.executable, WORKER, str(r), str(world), str(port), scene_npz,
             str(tmp / f"world{world}.npz")],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        ) for r in range(world)]
    try:
        for world, ps in procs.items():
            for r, p in enumerate(ps):
                log = p.communicate(timeout=GROUP_TIMEOUT)[0].decode()
                assert p.returncode == 0, f"world {world} rank {r}:\n{log[-3000:]}"
    finally:
        for p in (p for ps in procs.values() for p in ps):
            p.kill()
            p.wait()
    return {world: dict(np.load(tmp / f"world{world}.npz"))
            for world in WORLDS}


def jax_case(name):
    """(spp, render_sharded keywords) with JAX arrays for the tiles."""
    spp, kw = worker.case_args(worker.CASES[name])
    if "tile_offset" in kw:
        kw["tile_offset"] = jnp.asarray(kw["tile_offset"])
        kw["path_id_base"] = jnp.asarray(kw["path_id_base"], jnp.uint32)
    return spp, kw


@pytest.mark.parametrize("name", list(worker.CASES))
@pytest.mark.parametrize("world", WORLDS)
def test_sharded_render_matches_jax(groups, jax_scene, world, name):
    scene, camera = jax_scene
    spp, kw = jax_case(name)

    def render():
        return jshard.render_sharded(
            scene, camera, RenderSettings.from_flags(True), worker.RES, spp,
            worker.SEED, jmesh.make_mesh(world), **kw)

    got = groups[world]
    img, n_rays = render()
    assert np.isfinite(got[f"{name}/img"]).all()
    assert float(got[f"{name}/n_rays"]) == float(n_rays) > 0
    if name in EAGER:
        img, n_rays = jax_shards_op_by_op(scene, camera, world, spp, kw)
        assert float(got[f"{name}/n_rays"]) == float(n_rays)
    np.testing.assert_allclose(got[f"{name}/img"], np.asarray(img), **JAX_TOL)


def jax_shards_op_by_op(scene, camera, world, spp, kw):
    """JAX's render_sharded with each shard's fast.render_tile run op by
    op (shard_map compiles its body even under jax.disable_jit): the
    shards' path-id blocks of JAX shard.py:109-124, summed."""
    kw = dict(kw)
    assert kw.pop("kernel") == "fast" and "tile_dim" not in kw
    spp_shard, spp_rem = divmod(spp, world)
    n_pix = worker.RES[0] * worker.RES[1]
    blocks = [(spp_shard, r * n_pix * spp_shard) for r in range(world)
              if spp_shard] + [(spp_rem, n_pix * spp_shard * world)] * (
                  spp_rem > 0)
    img, n_rays = 0.0, 0.0
    with jax.disable_jit():
        for spp_n, base in blocks:
            i, n = jfast.render_tile(
                scene, camera, RenderSettings.from_flags(True), worker.RES,
                jnp.zeros(2, jnp.float32), worker.RES, spp_n, worker.SEED,
                jnp.uint32(base), **kw)
            img, n_rays = img + np.asarray(i), n_rays + float(n)
    return img, n_rays


def port_scene(jax_scene):
    """The port's scene and camera from the JAX scene's arrays."""
    a = scene_arrays(*jax_scene)
    scene = convert.scene_from_arrays(*(a[k] for k in (
        "density", "albedo", "albedo_affine", "box_min", "box_max", "scale",
        "max_density", "g", "roughness", "eta", "le")))
    return scene, convert.camera_from_arrays(a["inv_view"], a["raster_to_view"])


def port_single(name, jax_scene):
    """The port's single-process render_tile of the case's total spp."""
    scene, camera = port_scene(jax_scene)
    spp, kw = worker.case_args(worker.CASES[name])
    kernel = kw.pop("kernel")
    tile = kw.pop("tile_dim", worker.RES)
    offset = torch.from_numpy(np.asarray(kw.pop("tile_offset", np.zeros(2)),
                                         np.float32))
    base = kw.pop("path_id_base", 0)
    if isinstance(base, np.ndarray):
        base = torch.from_numpy(base)
    module = {"fast": fast, "streaming": streaming, "naive": naive}[kernel]
    return module.render_tile(
        scene, camera, ttypes.RenderSettings.from_flags(True), tile, offset,
        worker.RES, spp, worker.SEED, base, **kw)


@pytest.mark.parametrize("name", list(worker.CASES))
@pytest.mark.parametrize("world", WORLDS)
def test_sharded_render_matches_single_process(groups, jax_scene, world, name):
    img, n_rays = port_single(name, jax_scene)
    got = groups[world]
    assert float(got[f"{name}/n_rays"]) == float(n_rays)
    np.testing.assert_allclose(got[f"{name}/img"], img.numpy(), **tol(name))


def jax_inverse(jax_scene):
    """JAX's make_inverse_step on make_mesh(2) from the worker's start:
    (grids after the first step, every step's loss)."""
    scene, _ = jax_scene
    step = jshard.make_inverse_step(
        JSceneSpec.from_scene(scene),
        JCameraSpec(res_x=worker.RES[0], res_y=worker.RES[1], fov_x_deg=0.4),
        RenderSettings.from_flags(True, russian_roulette=False,
                                  max_path_length=8, bsdf_kind="null"),
        worker.RES, spp_per_device=worker.INVERSE_SPP, mesh=jmesh.make_mesh(2),
        optimizer=optax.sgd(worker.INVERSE_LR))
    params = (jnp.asarray(scene.medium.density.data),
              jnp.zeros_like(scene.medium.albedo.data))
    opt_state = optax.sgd(worker.INVERSE_LR).init(params)
    target = jnp.full(worker.RES + (3,), TARGET)
    first, losses = None, []
    for it in range(worker.INVERSE_STEPS):
        params, opt_state, loss = step(params, opt_state, target,
                                       worker.INVERSE_SEED + it)
        losses.append(float(loss))
        if it == 0:
            first = [np.asarray(p) for p in params]
    return first, np.asarray(losses, np.float32)


def test_inverse_step_matches_jax(groups, jax_scene):
    """Two ranks, one SGD step: the loss within 1e-5 of JAX's and each
    updated voxel within 1e-5 of JAX's plus 1e-4 of the largest update
    (test_torch_diff.py's cotangent tolerance; the null boundary, so both
    packages trace the same paths).  The albedo starts at zero, so no
    path carries radiance to it: its update is zero in both."""
    (j_density, j_albedo), j_losses = jax_inverse(jax_scene)
    got = groups[2]
    start = np.asarray(jax_scene[0].medium.density.data)
    np.testing.assert_allclose(got["inverse/losses"][0], j_losses[0],
                               rtol=1e-5)
    assert np.abs(j_density - start).max() > 0
    for name, want, was in (("density", j_density, start),
                            ("albedo", j_albedo, np.zeros_like(j_albedo))):
        step = np.abs(want - was).max()
        np.testing.assert_allclose(got[f"inverse/{name}"], want, rtol=1e-5,
                                   atol=1e-4 * step, err_msg=name)


def test_inverse_steps_descend(groups):
    """tests/test_sharding.py's criterion: finite, and the third loss at
    most 5% above the first (noisy Monte Carlo)."""
    losses = groups[2]["inverse/losses"]
    assert len(losses) == worker.INVERSE_STEPS and np.isfinite(losses).all()
    assert losses[-1] <= losses[0] * 1.05


@pytest.mark.parametrize("idx", [1, 2, 3])
def test_seed_and_base_wrap_like_uint32(idx):
    """Rank idx's seed (seed + idx * 0x9E3779B9) and first path id
    (base + idx * block) wrap mod 2^32 as JAX's jnp.uint32 sums do."""
    seed, base, block = 0xFFFFFFF0, 0xFFFFFF38, 64 * 5
    want_seed = jnp.uint32(seed) + jnp.uint32(idx) * jnp.uint32(tshard.SEED_SALT)
    assert tshard.device_seed(seed, idx) == int(want_seed)
    want_base = jnp.uint32(base) + jnp.asarray(idx * block).astype(jnp.uint32)
    assert tshard.shard_base(base, idx, block) == int(want_base)
    bases = torch.tensor([base, 7], dtype=torch.int64)
    np.testing.assert_array_equal(
        tshard.shard_base(bases, idx, block).numpy(),
        np.asarray(jnp.asarray([base, 7], jnp.uint32)
                   + jnp.asarray(idx * block).astype(jnp.uint32)))


def test_make_mesh_needs_a_group():
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="initialize_distributed"):
        tmesh.make_mesh(device="cpu")


def test_ranks_render_on_the_card_unless_asked_for_the_cpu(monkeypatch):
    """No fallback: without a card a rank's default device raises; the
    CPU is taken only when asked for."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--platform cpu"):
        tmesh.rank_device()
    with pytest.raises(RuntimeError, match="--platform cpu"):
        tmesh.initialize_distributed(world_size=1, rank=0)
    assert tmesh.rank_device("cpu") == torch.device("cpu")


def test_one_rank_group_in_process(jax_scene):
    """A gloo group of one in this process: make_mesh checks n_devices,
    render_sharded equals the single-process render bit for bit (one rank
    renders every sample) and refuses an unknown kernel (on every rank,
    before any collective) and a scene on another device."""
    tmesh.initialize_distributed(
        init_method=f"tcp://127.0.0.1:{free_port()}", world_size=1, rank=0,
        device="cpu")
    try:
        with pytest.raises(ValueError, match="one rank per device"):
            tmesh.make_mesh(2, device="cpu")
        mesh = tmesh.make_mesh(1, device="cpu")
        assert (mesh.world_size, mesh.rank, mesh.axis_name) == (1, 0, "rays")
        img, n_rays = port_single("fast-spp5", jax_scene)
        scene, camera = port_scene(jax_scene)
        spp, kw = worker.case_args(worker.CASES["fast-spp5"])
        got, got_rays = tshard.render_sharded(
            scene, camera, ttypes.RenderSettings.from_flags(True), worker.RES,
            spp, worker.SEED, mesh, **kw)
        np.testing.assert_array_equal(got.numpy(), img.numpy())
        assert float(got_rays) == float(n_rays)
        with pytest.raises(ValueError, match="'fast', 'streaming'"):
            tshard.render_sharded(
                scene, camera, ttypes.RenderSettings.from_flags(True),
                worker.RES, spp, worker.SEED, mesh, kernel="brick")
        other = tmesh.Mesh(mesh.group, 1, 0, "rays", torch.device("meta"))
        with pytest.raises(ValueError, match="build it there"):
            tshard.render_sharded(
                scene, camera, ttypes.RenderSettings.from_flags(True),
                worker.RES, spp, worker.SEED, other, **kw)
    finally:
        dist.destroy_process_group()
