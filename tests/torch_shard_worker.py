"""One rank of tests/test_torch_parallel.py's gloo groups.

    python tests/torch_shard_worker.py RANK WORLD PORT SCENE.npz OUT.npz

Joins a CPU process group of WORLD ranks at tcp://127.0.0.1:PORT, builds
the scene and camera from SCENE.npz (the JAX scene's arrays), renders
every case of CASES with the port's render_sharded and, with two ranks,
runs INVERSE_STEPS steps of make_inverse_step; rank 0 writes the results
to OUT.npz.  Imports torch and the port only.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from cudavolumerenderer_tpu_torch import convert  # noqa: E402
from cudavolumerenderer_tpu_torch.models.differentiable import (  # noqa: E402
    CameraSpec, SceneSpec,
)
from cudavolumerenderer_tpu_torch.parallel import mesh as pmesh  # noqa: E402
from cudavolumerenderer_tpu_torch.parallel import shard  # noqa: E402
from cudavolumerenderer_tpu_torch.scene.types import RenderSettings  # noqa: E402

RES = (8, 8)
SEED = 3
#: 2^32 - 200: ranks' first path ids wrap past 2^32 (uint32, as JAX's)
WRAP_BASE = 0xFFFFFF38
#: the multi-tile cases' tiles: four 4x4 tiles of the 8x8 image
TILE, TILE_OFFSETS = (4, 4), ((0, 0), (4, 0), (0, 4), (4, 4))
CHAMPION = dict(table_bits=4, cascade_factor=1.25)
#: name -> render_sharded arguments: kernel, spp and keywords; "tiles"
#: renders TILE_OFFSETS in one cascade with per-tile bases
CASES = {
    "naive": dict(kernel="naive", spp=8),
    "naive-wrap": dict(kernel="naive", spp=8, path_id_base=WRAP_BASE),
    "streaming": dict(kernel="streaming", spp=8),
    "fast-one": dict(kernel="fast", spp=8),
    "fast-two": dict(kernel="fast", spp=8, two_level=True),
    "fast-spp5": dict(kernel="fast", spp=5, two_level=True),
    "fast-spp13": dict(kernel="fast", spp=13, two_level=True),
    "fast-spp3": dict(kernel="fast", spp=3, two_level=True),
    "knobs": dict(kernel="fast", spp=8, two_level=True, cascade_factor=1.25,
                  min_width=256),
    "q4": dict(kernel="fast", spp=7, two_level=True, table_bits=4),
    "champion-tiles": dict(kernel="fast", spp=5, two_level=True, tiles=True,
                           **CHAMPION),
}
#: tests/test_sharding.py's inverse step: spp per rank, SGD rate, steps
INVERSE_SPP, INVERSE_LR, INVERSE_STEPS, INVERSE_SEED = 32, 5.0, 3, 100


def tile_bases(spp: int, base: int = 0) -> np.ndarray:
    """Tile t's first path id, as the renderer's multi-tile pass gives
    them: base + t * tile pixels * spp."""
    n_pix = TILE[0] * TILE[1]
    return base + np.arange(len(TILE_OFFSETS), dtype=np.int64) * n_pix * spp


def case_args(case: dict):
    """(spp, render_sharded keywords) of a case, tiles made explicit."""
    kw = dict(case)
    spp = kw.pop("spp")
    if kw.pop("tiles", False):
        kw.update(tile_dim=TILE,
                  tile_offset=np.asarray(TILE_OFFSETS, np.float32),
                  path_id_base=tile_bases(spp))
    return spp, kw


def main(argv) -> int:
    rank, world, port = (int(a) for a in argv[1:4])
    scene_npz, out = argv[4], argv[5]
    pmesh.initialize_distributed(
        init_method=f"tcp://127.0.0.1:{port}", world_size=world, rank=rank,
        device="cpu",
    )
    try:
        mesh = pmesh.make_mesh(world, device="cpu")
        a = np.load(scene_npz)
        scene = convert.scene_from_arrays(
            a["density"], a["albedo"], a["albedo_affine"], a["box_min"],
            a["box_max"], a["scale"], a["max_density"], a["g"],
            a["roughness"], a["eta"], a["le"])
        camera = convert.camera_from_arrays(a["inv_view"], a["raster_to_view"])
        settings = RenderSettings.from_flags(True)
        results = {}
        for name, case in CASES.items():
            spp, kw = case_args(case)
            if isinstance(kw.get("path_id_base"), np.ndarray):
                kw["path_id_base"] = torch.from_numpy(kw["path_id_base"])
            img, n_rays = shard.render_sharded(
                scene, camera, settings, RES, spp, SEED, mesh, **kw)
            results[f"{name}/img"] = img.numpy()
            results[f"{name}/n_rays"] = n_rays.numpy()
        if world == 2:
            results.update(inverse_steps(scene, mesh, a["target"]))
        if rank == 0:
            np.savez(out, **results)
        return 0
    finally:
        torch.distributed.destroy_process_group()


def inverse_steps(scene, mesh, target) -> dict:
    """INVERSE_STEPS steps from tests/test_sharding.py's start (the
    scene's density, zero albedo): the grids after the first step and
    every step's loss."""
    step = shard.make_inverse_step(
        SceneSpec.from_scene(scene),
        CameraSpec(res_x=RES[0], res_y=RES[1], fov_x_deg=0.4),
        RenderSettings.from_flags(True, russian_roulette=False,
                                  max_path_length=8, bsdf_kind="null"),
        RES, INVERSE_SPP, mesh, lambda p: torch.optim.SGD(p, lr=INVERSE_LR))
    params = (scene.medium.density.data.clone().requires_grad_(),
              torch.zeros_like(scene.medium.albedo.data).requires_grad_())
    target = torch.from_numpy(target)
    out, losses = {}, []
    for it in range(INVERSE_STEPS):
        params, loss = step(params, target, INVERSE_SEED + it)
        losses.append(float(loss))
        if it == 0:
            out["inverse/density"] = params[0].detach().numpy().copy()
            out["inverse/albedo"] = params[1].detach().numpy().copy()
    out["inverse/losses"] = np.asarray(losses, np.float32)
    return out


if __name__ == "__main__":
    sys.exit(main(sys.argv))
