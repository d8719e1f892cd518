"""Inverse rendering: recover density/albedo grids from target renders
(port of cudavolumerenderer_tpu/models/inverse.py).

Builds on the path-replay render_diff (models/differentiable.py) and
keeps the JAX package's checkpoint/resume: one .npz per checkpoint with
the grids, the step, the seed and the Adam moments.

Port notes: torch.optim.Adam takes the place of optax.adam (the same
update; defaults b1 0.9, b2 0.999, eps 1e-8), and the clip is applied in
place under no_grad.  The optimizer state crosses checkpoints as an
`AdamState` written in optax's leaf order (count, then mu per parameter,
then nu per parameter), so a checkpoint written by either package
resumes in the other.  The entry points run on the card unless the
caller passes device="cpu"; without a card they raise.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.rng import M32
from ..scene.types import RenderSettings, loader_device
from .differentiable import CameraSpec, SceneSpec, render_diff


@dataclasses.dataclass
class InverseConfig:
    resolution: Tuple[int, int] = (32, 32)
    spp: int = 64
    learning_rate: float = 0.5
    n_steps: int = 200
    seed: int = 7
    optimize_albedo: bool = False
    #: sparse-leap stochastic-tap estimator for fwd+bwd — required for
    #: large grids (global-majorant replay is intractable at 256^3+)
    two_level: bool = False
    clip_density: Tuple[float, float] = (0.0, 1.0)
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 50
    #: total-variation smoothness prior weight on the density grid
    #: (0 = off)
    tv_weight: float = 0.0
    #: views per step when running multi-view: cycles through the view
    #: set round-robin so every step renders only `views_per_step` images
    views_per_step: int = 1
    #: split each view's fwd+bwd into this many independent sample chunks
    #: of spp/spp_chunks each, whose grads are averaged.  Per-view
    #: splitting is exact (the multi-view loss is a mean of per-view
    #: MSEs); spp splitting swaps MSE-of-mean for mean-of-chunk-MSE, the
    #: surrogate the per-step stochastic loss already minimises.
    spp_chunks: int = 1


class AdamState(NamedTuple):
    """Adam's state in optax's terms: the step count and the first and
    second moments of each parameter."""

    count: int
    mu: Tuple[torch.Tensor, ...]
    nu: Tuple[torch.Tensor, ...]

    def leaves(self) -> list:
        """optax's leaf order: count, mu per parameter, nu per parameter."""
        return [self.count, *self.mu, *self.nu]


def adam_init(params: Sequence[torch.Tensor]) -> AdamState:
    """The state of a fresh Adam (optax.adam(lr).init(params))."""
    return AdamState(0, tuple(torch.zeros_like(p) for p in params),
                     tuple(torch.zeros_like(p) for p in params))


def make_adam(params: Sequence[torch.Tensor], lr: float,
              state: Optional[AdamState] = None) -> torch.optim.Adam:
    """torch.optim.Adam over params, resumed from `state` when given."""
    optimizer = torch.optim.Adam(list(params), lr=lr)
    if state is not None:
        if len(state.mu) != len(params):
            raise ValueError(
                f"Adam state for {len(state.mu)} parameters, {len(params)} given"
            )
        for p, m, v in zip(params, state.mu, state.nu):
            optimizer.state[p] = {
                "step": torch.tensor(float(state.count), dtype=torch.float32),
                "exp_avg": m.detach().to(p.device, torch.float32).clone(),
                "exp_avg_sq": v.detach().to(p.device, torch.float32).clone(),
            }
    return optimizer


def adam_state(optimizer: torch.optim.Adam) -> AdamState:
    """The optimizer's state as an AdamState (zeros before its first
    step, as optax's init)."""
    params = [p for group in optimizer.param_groups for p in group["params"]]
    states = [optimizer.state.get(p, {}) for p in params]
    if not all(states):
        return adam_init([p.detach() for p in params])
    return AdamState(
        int(states[0]["step"]),
        tuple(s["exp_avg"].detach().clone() for s in states),
        tuple(s["exp_avg_sq"].detach().clone() for s in states),
    )


def _as_tensor(x, device) -> torch.Tensor:
    """A float32 copy of x on device (numpy arrays, tensors and scalars)."""
    if isinstance(x, torch.Tensor):
        return x.detach().to(device=device, dtype=torch.float32).clone()
    return torch.tensor(np.asarray(x, np.float32), device=device)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def make_loss_fn(
    scene_spec: SceneSpec,
    camera_spec: CameraSpec,
    settings: RenderSettings,
    config: InverseConfig,
):
    spp = config.spp

    def loss_fn(density, albedo, target, seed):
        img = render_diff(
            density, albedo, seed, scene_spec, camera_spec, settings,
            config.resolution, spp, config.two_level,
        ) / float(spp)
        return torch.mean((img - target) ** 2)

    return loss_fn


def _tv_loss(density: torch.Tensor) -> torch.Tensor:
    """Anisotropic total-variation prior: mean squared forward
    difference along each axis."""
    t = 0.0
    for ax in range(3):
        d = torch.diff(density, dim=ax)
        t = t + torch.mean(d * d)
    return t / 3.0


def make_multiview_loss_fn(
    scene_spec: SceneSpec,
    camera_specs: Sequence[CameraSpec],
    settings: RenderSettings,
    config: InverseConfig,
):
    """Mean MSE over several camera poses; `targets` stacks the per-view
    images (V, H, W, 3), and the view index is hashed into the seed."""
    spp = config.spp

    def loss_fn(density, albedo, targets, seed):
        total = 0.0
        for v, cam_spec in enumerate(camera_specs):
            view_seed = (seed + v * 2246822519 % (1 << 31)) & M32
            img = render_diff(
                density, albedo, view_seed, scene_spec, cam_spec,
                settings, config.resolution, spp, config.two_level,
            ) / float(spp)
            total = total + torch.mean((img - targets[v]) ** 2)
        total = total / float(len(camera_specs))
        if config.tv_weight > 0.0:
            total = total + config.tv_weight * _tv_loss(density)
        return total

    return loss_fn


def make_view_loss_fn(
    scene_spec: SceneSpec,
    camera_proto: CameraSpec,
    settings: RenderSettings,
    config: InverseConfig,
):
    """One loss for every pose: the camera is an argument (render_diff's
    `camera` override).  `stats` is passed on to render_diff."""
    spp = config.spp

    def loss_fn(density, albedo, target, seed, camera, stats=None):
        img = render_diff(
            density, albedo, seed, scene_spec, camera_proto, settings,
            config.resolution, spp, config.two_level, camera, stats=stats,
        ) / float(spp)
        loss = torch.mean((img - target) ** 2)
        if config.tv_weight > 0.0:
            loss = loss + config.tv_weight * _tv_loss(density)
        return loss

    return loss_fn


def orbit_camera_specs(
    n_views: int,
    radius: float = 100.0,
    res: Tuple[int, int] = (32, 32),
    fov_x_deg: float = 0.7,
    center: Tuple[float, float, float] = (0.0, 0.0, 0.0),
) -> Tuple[CameraSpec, ...]:
    """Evenly spaced look-at poses on a horizontal orbit around the
    volume."""
    specs = []
    for v in range(n_views):
        theta = 2.0 * np.pi * v / n_views
        eye = (
            center[0] + radius * float(np.sin(theta)),
            center[1],
            center[2] + radius * float(np.cos(theta)),
        )
        specs.append(
            CameraSpec(
                res_x=res[0], res_y=res[1], fov_x_deg=fov_x_deg,
                position=eye, look_at=center,
            )
        )
    return tuple(specs)


def _save_checkpoint(path, step, density, albedo, opt_state, seed=None):
    """Write one self-contained .npz checkpoint: grid(s) + step + seed +
    the Adam state in optax's leaf order.  All sample streams derive from
    (config.seed, step), so those two scalars are the PRNG state."""
    os.makedirs(path, exist_ok=True)

    def host(x):
        return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else (
            np.asarray(x))

    payload = {
        "density": host(density),
        "albedo": host(albedo),
        "step": np.int64(step),
    }
    if seed is not None:
        payload["seed"] = np.int64(seed)
    if opt_state is not None:
        leaves = opt_state.leaves()
        payload["n_opt_leaves"] = np.int64(len(leaves))
        payload["opt_0"] = np.int32(leaves[0])
        for i, leaf in enumerate(leaves[1:], 1):
            payload[f"opt_{i}"] = host(leaf)
    # np.savez appends .npz when missing, so the tmp name must carry it
    tmp = os.path.join(path, f".tmp_step_{step}.npz")
    np.savez(tmp, **payload)
    os.replace(tmp, os.path.join(path, f"step_{step}.npz"))


def load_checkpoint(path: str, step: int,
                    opt_state_like: Optional[AdamState] = None):
    """Load a checkpoint.  Returns (density, albedo, step) as numpy — plus
    the restored AdamState when `opt_state_like` (a template, e.g.
    adam_init(params)) is given: None if the checkpoint has no moments."""
    from ..convert import adam_state_from_optax_leaves  # noqa: PLC0415

    data = np.load(os.path.join(path, f"step_{step}.npz"))
    out = (data["density"], data["albedo"], int(data["step"]))
    if opt_state_like is None:
        return out
    if "n_opt_leaves" not in data.files:
        return out + (None,)
    n = int(data["n_opt_leaves"])
    template = opt_state_like.leaves()
    if len(template) != n:
        raise ValueError(
            f"checkpoint has {n} optimizer leaves, template has "
            f"{len(template)} — optimizer mismatch"
        )
    device = opt_state_like.mu[0].device if opt_state_like.mu else "cpu"
    return out + (adam_state_from_optax_leaves(
        [data[f"opt_{i}"] for i in range(n)], device=device),)


def find_latest_checkpoint(path: str):
    """Largest checkpointed step in `path`, or None."""
    if not os.path.isdir(path):
        return None
    steps = []
    for name in os.listdir(path):
        if name.startswith("step_") and name.endswith(".npz"):
            try:
                steps.append(int(name[len("step_"):-len(".npz")]))
            except ValueError:
                continue
    return max(steps) if steps else None


def run_inverse(
    target,  # (H, W, 3) target image (mean radiance), or (V, H, W, 3)
    density0,
    albedo0,
    scene_spec: SceneSpec,
    camera_spec,
    settings: RenderSettings,
    config: InverseConfig,
    progress: Optional[Callable[[int, float], None]] = None,
    device="cuda",
):
    """Adam-optimise the density (and optionally albedo) grid to match
    the target.  Per-step fresh sample streams (seed + step) keep the
    gradient estimator unbiased across steps.  Returns (density, albedo,
    losses).

    Multi-view: pass a sequence of CameraSpec (e.g. orbit_camera_specs)
    and a stacked (V, H, W, 3) target; the loss averages over views."""
    device = loader_device(device)
    if isinstance(camera_spec, (list, tuple)):
        loss_fn = make_multiview_loss_fn(scene_spec, camera_spec, settings,
                                         config)
    else:
        loss_fn = make_loss_fn(scene_spec, camera_spec, settings, config)
    target = _as_tensor(target, device)
    density = _as_tensor(density0, device).requires_grad_(True)
    albedo = _as_tensor(albedo0, device)
    if config.optimize_albedo:
        albedo.requires_grad_(True)
    params = [density, albedo] if config.optimize_albedo else [density]
    optimizer = make_adam(params, config.learning_rate)
    losses = []
    lo, hi = config.clip_density
    for step in range(config.n_steps):
        seed = (config.seed + step * 2654435761 % (1 << 31)) & M32
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(density, albedo, target, seed)
        loss.backward()
        optimizer.step()
        with torch.no_grad():
            if config.optimize_albedo:
                albedo.clamp_(0.0, 1.0)
            density.clamp_(lo, hi)
        losses.append(float(loss.detach()))
        if progress is not None:
            progress(step, losses[-1])
        if (
            config.checkpoint_dir
            and (step + 1) % config.checkpoint_every == 0
        ):
            _save_checkpoint(
                config.checkpoint_dir, step + 1, density, albedo,
                adam_state(optimizer), seed=config.seed,
            )
    return density.detach(), albedo.detach(), losses


# ---------------------------------------------------------------------------
# Multi-view SGD + coarse-to-fine pyramid — the BASELINE config 5 recipe
# ---------------------------------------------------------------------------

def render_view_targets(
    density,
    albedo,
    scene_spec: SceneSpec,
    camera_specs: Sequence[CameraSpec],
    settings: RenderSettings,
    resolution: Tuple[int, int],
    spp: int,
    two_level: bool,
    seed: int = 999,
    device="cuda",
) -> torch.Tensor:
    """High-spp reference renders of the ground truth for each view,
    (V, H, W, 3) mean radiance.  Targets need no gradients, so they use
    the fastSK forward renderer (models/fast) — the same estimator
    family as the loss's renders."""
    from . import fast  # noqa: PLC0415

    device = loader_device(device)
    scene = scene_spec.build(_as_tensor(density, device),
                             _as_tensor(albedo, device), device=device)
    tw, th = resolution
    targets = []
    for v, spec in enumerate(camera_specs):
        vs = int((seed + v * 2246822519) % (1 << 31))
        img, _ = fast.render_tile(
            scene, spec.build(device), settings, (tw, th),
            torch.zeros(2, dtype=torch.float32, device=device), (tw, th),
            spp, vs, 0, two_level=two_level,
        )
        targets.append(img / float(spp))
    return torch.stack(targets)


def run_inverse_views(
    targets,  # (V, H, W, 3)
    camera_specs: Sequence[CameraSpec],
    density0,
    albedo0,
    scene_spec: SceneSpec,
    settings: RenderSettings,
    config: InverseConfig,
    progress: Optional[Callable[[int, float], None]] = None,
    opt_state: Optional[AdamState] = None,
    start_step: int = 0,
    device="cuda",
    stats: Optional[dict] = None,
):
    """Adam over round-robin view minibatches.  Each (view, sample chunk)
    is its own forward and backward; grads are averaged across the
    config.views_per_step x config.spp_chunks programs of a step.

    start_step resumes mid-run: seeds derive from (config.seed, step), so
    a run resumed at k (with the checkpointed opt_state) replays the
    unbroken run's steps k.. exactly.  `stats`, when a dict, gains lists
    of the seconds per step ("step_s") and per forward+backward program
    ("program_s", each ended by a device synchronise) and render_diff's
    replay iterations.  Returns (density, losses, opt_state)."""
    device = loader_device(device)
    n_chunks = max(1, int(config.spp_chunks))
    if config.spp % n_chunks != 0:
        raise ValueError(
            f"spp={config.spp} not divisible by spp_chunks={n_chunks}: "
            "the chunked loss would silently drop samples"
        )
    chunk_cfg = dataclasses.replace(config, spp=max(1, config.spp // n_chunks))
    loss_fn = make_view_loss_fn(scene_spec, camera_specs[0], settings,
                                chunk_cfg)
    cameras = [spec.build(device) for spec in camera_specs]
    n_views = len(cameras)
    targets = _as_tensor(targets, device)
    albedo = _as_tensor(albedo0, device)
    density = _as_tensor(density0, device).requires_grad_(True)
    optimizer = make_adam([density], config.learning_rate, opt_state)
    losses = []
    lo, hi = config.clip_density
    n_parts = config.views_per_step * n_chunks
    for step in range(start_step, config.n_steps):
        t_step = time.perf_counter()
        views = [
            (step * config.views_per_step + j) % n_views
            for j in range(config.views_per_step)
        ]
        optimizer.zero_grad(set_to_none=True)
        loss = 0.0
        for v in views:
            for c in range(n_chunks):
                seed = (
                    config.seed
                    + step * 2654435761
                    + v * 2246822519
                    + c * 3266489917
                ) % (1 << 31)
                t_prog = time.perf_counter()
                l_c = loss_fn(density, albedo, targets[v], seed, cameras[v],
                              stats)
                l_c.backward()  # adds this program's grad into density.grad
                loss = loss + l_c.detach()
                if stats is not None:
                    _sync(device)
                    stats.setdefault("program_s", []).append(
                        time.perf_counter() - t_prog)
        loss = loss / n_parts
        density.grad.div_(n_parts)
        optimizer.step()
        with torch.no_grad():
            density.clamp_(lo, hi)
        losses.append(float(loss))
        if stats is not None:
            stats.setdefault("step_s", []).append(time.perf_counter() - t_step)
        if progress is not None:
            progress(step, losses[-1])
        if (
            config.checkpoint_dir
            and (step + 1) % config.checkpoint_every == 0
        ):
            _save_checkpoint(
                config.checkpoint_dir, step + 1, density, albedo,
                adam_state(optimizer), seed=config.seed,
            )
    return density.detach(), losses, adam_state(optimizer)


def observability_depth(
    density: np.ndarray, scale: float, aabb_extent: float = 1.0
) -> np.ndarray:
    """Per-voxel minimal optical depth to the volume boundary, the best
    of the six axis-aligned exit paths: an upper bound on the true
    minimal escape depth, so voxels it flags unobservable are likely
    (not provably) unobservable and voxels it flags observable certainly
    are.  Returns an array shaped like ``density`` of the min-over-6
    exclusive cumulative optical depth (sigma_t = density * scale, voxel
    size = aabb_extent / n per axis)."""
    d = np.asarray(density, np.float64)
    out = np.full(d.shape, np.inf)
    for axis in range(3):
        dx = aabb_extent / d.shape[axis]
        sig = d * scale * dx
        # exclusive cumsum from each face: depth BEFORE entering voxel
        cum = np.cumsum(sig, axis=axis) - sig
        out = np.minimum(out, cum)
        rcum = (
            np.flip(np.cumsum(np.flip(sig, axis=axis), axis=axis),
                    axis=axis) - sig
        )
        out = np.minimum(out, rcum)
    return out


def split_mse_by_observability(
    recovered: np.ndarray,
    truth: np.ndarray,
    init_value: float,
    scale: float,
    tau_c: float = 5.0,
):
    """Grid-MSE ratio (final/init) separately over the observable shell
    (min escape optical depth < tau_c) and the unobservable interior."""
    tau = observability_depth(truth, scale)
    shell = tau < tau_c
    rec = np.asarray(recovered, np.float64)
    tr = np.asarray(truth, np.float64)
    res = {}
    for name, mask in (("shell", shell), ("interior", ~shell)):
        n = int(mask.sum())
        if n == 0:
            res[name] = {"n_voxels": 0}
            continue
        mse0 = float(((init_value - tr[mask]) ** 2).mean())
        mse1 = float(((rec[mask] - tr[mask]) ** 2).mean())
        res[name] = {
            "n_voxels": n,
            "mse_init": round(mse0, 6),
            "mse_final": round(mse1, 6),
            "mse_ratio": round(mse1 / max(mse0, 1e-12), 4),
        }
    res["tau_c"] = tau_c
    res["shell_frac"] = round(float(shell.mean()), 4)
    return res


def upsample_density(density: torch.Tensor, shape_zyx) -> torch.Tensor:
    """Trilinear upsampling between pyramid levels.  Half-pixel centres
    with the source coordinate clamped at the border: for an upsample by
    2 the same weights as jax.image.resize's border-normalised triangle
    kernel."""
    return F.interpolate(
        density[None, None], size=tuple(shape_zyx), mode="trilinear",
        align_corners=False,
    )[0, 0]


def run_inverse_pyramid(
    targets,
    camera_specs: Sequence[CameraSpec],
    albedo0,
    scene_spec: SceneSpec,
    settings: RenderSettings,
    config: InverseConfig,
    levels: Sequence[Tuple[int, int]],  # [(grid_n, n_steps), ...]
    init_value: float = 0.25,
    progress: Optional[Callable[[str, int, float], None]] = None,
    resume: bool = False,
    device="cuda",
    stats: Optional[dict] = None,
):
    """Coarse-to-fine recovery: optimise a small grid first, trilinearly
    upsample, continue.  The targets are fixed full-resolution renders of
    the ground truth; only the optimised grid changes size.

    Checkpoint/resume: with config.checkpoint_dir set, each level
    checkpoints into `<dir>/L<grid_n>` (including a forced final-step
    checkpoint), and `resume=True` restarts from the deepest level that
    has a checkpoint: completed coarse levels are skipped, the
    interrupted level continues at its saved step with its saved Adam
    moments, and the seed schedule replays exactly.  `stats`, when a
    dict, gains one run_inverse_views stats dict per level run, under
    "levels" keyed "<n>^3".  Returns (density, per_level_losses)."""
    device = loader_device(device)
    targets = _as_tensor(targets, device)
    albedo0 = _as_tensor(albedo0, device)
    density = torch.full((levels[0][0],) * 3, init_value, dtype=torch.float32,
                         device=device)
    all_losses = []
    # resume: deepest level with any checkpoint wins
    resume_li, resume_step = -1, 0
    if resume and config.checkpoint_dir:
        for li, (n, steps) in enumerate(levels):
            latest = find_latest_checkpoint(
                os.path.join(config.checkpoint_dir, f"L{n}"))
            if latest is not None:
                resume_li, resume_step = li, latest
    for li, (n, steps) in enumerate(levels):
        lvl_dir = (
            os.path.join(config.checkpoint_dir, f"L{n}")
            if config.checkpoint_dir
            else None
        )
        if li < resume_li:
            all_losses.append([])
            continue  # completed level; the deeper checkpoint carries it
        opt_state = None
        start_step = 0
        if li == resume_li:
            tpl = adam_init([torch.zeros((n, n, n), device=device)])
            d_ck, _, step_ck, opt_state = load_checkpoint(
                lvl_dir, resume_step, opt_state_like=tpl
            )
            density = torch.as_tensor(d_ck, device=device)
            start_step = step_ck
            if start_step >= steps:
                all_losses.append([])
                continue  # level already finished; move to the next
        elif density.shape[0] != n:
            density = torch.clamp(
                upsample_density(density, (n, n, n)), *config.clip_density
            )
        lvl_cfg = dataclasses.replace(
            config, n_steps=steps, checkpoint_dir=lvl_dir
        )
        lvl_stats = None
        if stats is not None:
            lvl_stats = stats.setdefault("levels", {}).setdefault(f"{n}^3", {})
        density, losses, opt_state = run_inverse_views(
            targets, camera_specs, density, albedo0, scene_spec,
            settings, lvl_cfg,
            progress=(
                None
                if progress is None
                else (lambda s, l, _n=n: progress(f"{_n}^3", s, l))
            ),
            opt_state=opt_state,
            start_step=start_step,
            device=device,
            stats=lvl_stats,
        )
        if lvl_dir:
            _save_checkpoint(
                lvl_dir, steps, density, albedo0, opt_state,
                seed=config.seed,
            )
        all_losses.append(losses)
    return density, all_losses
