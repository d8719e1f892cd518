"""The family bounce's lookahead schedule (csrc/familybody.cu) on the CPU.

The bounce kernel and naiveSK's drain run each lane's Woodcock chain in
rounds, a group of G threads per lane.  Member j of a round takes step j:
it reaches draws 2j+1 (the flight) and 2j+2 (the acceptance uniform) of
the lane's PCG stream by jump-ahead (ops/rng.jump_constants), forms t_j as
the eager loop's left-to-right sum t + s_0 + ... + s_j over the steps
shared by shuffles (adding -0.0 for the steps after j), reads the density
at o + t_j d and tests its step.  The first member whose step crosses
max_t or accepts ends the chain: the lane takes its t and its PCG state.
A round in which no step stops hands its last step's t and state to the
next round of G steps.  The kernel cannot run here, so this file holds:

- the jump table against the JAX package's sequential draws, two a step,
  m up to 2 * 32 + 2;
- a plain torch model of that schedule (`lookahead_track`, with
  woodcock_track's signature), which must give woodcock_track's t, events,
  PCG state and per-lane step counts bit for bit and JAX's woodcock_track
  (t to XLA's last bits); and in place of woodcock_track inside
  bounce_step (every event step taken by the eager code) bounce_step's
  outputs bit for bit.
tests/test_torch_cuda.py holds the kernels against the eager bounce on the
card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cudavolumerenderer_tpu.ops import rng as jrng
from cudavolumerenderer_tpu.ops import woodcock as jwood
from cudavolumerenderer_tpu.scene import procedural
from cudavolumerenderer_tpu.scene import types as jtypes
from cudavolumerenderer_tpu_torch import convert
from cudavolumerenderer_tpu_torch.constants import EPSILON
from cudavolumerenderer_tpu_torch.models import integrator
from cudavolumerenderer_tpu_torch.ops import aabb
from cudavolumerenderer_tpu_torch.ops import familybody as fam
from cudavolumerenderer_tpu_torch.ops import grid as tgrid
from cudavolumerenderer_tpu_torch.ops import rng as trng
from cudavolumerenderer_tpu_torch.ops import woodcock as twood
from cudavolumerenderer_tpu_torch.scene.types import RenderSettings

torch.set_num_threads(2)

M32 = 0xFFFFFFFF
MAX_G = 32  # the kernel's largest group: one warp per lane


def test_jump_table_equals_sequential_draws():
    """A_m * s + G_m * inc is the JAX PCG state after m draws, two draws a
    step (next_float twice), m <= 2 * 32 + 2: member j of a 32-thread group
    starts at draw 2j + 1 and ends at 2j + 2."""
    n = 2 * MAX_G + 2
    table = trng.jump_constants(n).numpy().astype(np.uint64)
    assert table.shape == (2, n + 1)
    rs = np.random.RandomState(7)
    state = rs.randint(0, 1 << 32, 256, dtype=np.int64)
    state[:2] = (0, M32)
    inc = rs.randint(0, 1 << 31, 256, dtype=np.int64) * 2 + 1
    st = jrng.RngState(jnp.asarray(state.astype(np.uint32)),
                       jnp.asarray(inc.astype(np.uint32)))
    s, c = state.astype(np.uint64), inc.astype(np.uint64)
    for step in range(n // 2 + 1):
        for m in (2 * step, 2 * step + 1):
            if m > n:
                break
            jumped = (table[0, m] * s + table[1, m] * c) & M32
            np.testing.assert_array_equal(
                jumped, np.asarray(st.state).astype(np.uint64),
                err_msg=f"m = {m}")
            _, st = jrng.next_float(st)


def mul32(a, b):
    """(a * b) mod 2^32 for int64 tensors of uint32 words."""
    return (a * (b & 0xFFFF) + (((a * (b >> 16)) & 0xFFFF) << 16)) & M32


def uniform(state):
    """The float a draw that lands on `state` returns (rng.next_float)."""
    word = mul32((state >> ((state >> 28) + 4)) ^ state, 277803737)
    bits = (word >> 22) ^ word
    return (bits >> 8).to(torch.float32) * (1.0 / (1 << 24))


def lookahead_track(density, box_min, box_max, density_scale, max_density,
                    o, d, max_t, rng, active, interpolation="trilinear",
                    check_every=None, taps=None, *, G, stats=None):
    """The kernel's schedule in plain torch, with woodcock_track's
    signature and result (n_steps: the longest lane's steps); `stats`, a
    dict, receives each lane's steps and rounds.

    A round of G steps: member j jumps to draw 2j + 1, draws u1 and u2,
    forms t_j = t + s_0 + ... + s_j left to right (-0.0 for the steps
    after j), samples the density at o + t_j d and stops where t_j > max_t
    or the step accepts.  The first stopping member gives the lane its t
    and state; without one, member G - 1."""
    inv_sigmat, scale = twood._inv_sigmat(density_scale, max_density,
                                          o.device)
    extent = box_max - box_min
    n = max_t.shape[0]
    table = trng.jump_constants(2 * G)
    j = torch.arange(G)
    a_j, g_j = table[0][2 * j + 1], table[1][2 * j + 1]
    t = torch.zeros(n, dtype=torch.float32)
    state, inc = rng.state.clone(), rng.inc
    steps = torch.zeros(n, dtype=torch.int64)
    rounds = torch.zeros(n, dtype=torch.int64)
    running = active.clone()
    while bool(running.any()):
        s1 = (mul32(state[:, None], a_j) + mul32(inc[:, None], g_j)) & M32
        s2 = (mul32(s1, trng._MULT) + inc[:, None]) & M32
        step = -torch.log(torch.clamp(uniform(s1), min=EPSILON)) * inv_sigmat
        tj = t[:, None].expand(n, G)
        for i in range(G):  # left to right, as the eager loop adds
            tj = tj + torch.where((i <= j)[None, :], step[:, i:i + 1], -0.0)
        p01 = (o[:, None, :] + tj[..., None] * d[:, None, :] - box_min) / extent
        rho = tgrid.sample(density, p01, interpolation)
        keep = (tj <= max_t[:, None]) & (scale * rho * inv_sigmat
                                         < uniform(s2))
        stop = ~keep & running[:, None]
        has = stop.any(1)
        take = torch.where(has, stop.to(torch.int64).argmax(1), G - 1)
        t = torch.where(running, tj.gather(1, take[:, None])[:, 0], t)
        state = torch.where(running, s2.gather(1, take[:, None])[:, 0], state)
        steps = steps + torch.where(running, take + 1, 0)
        rounds = rounds + running
        running = running & ~has
    if stats is not None:
        stats.update(steps=steps, rounds=rounds)
    return twood.WoodcockResult(
        t=t, scattered=active & (t < max_t), rng=trng.RngState(state, inc),
        n_steps=steps.max() if n else torch.zeros((), dtype=torch.int64))


def bits(x):
    return x.view(torch.int32) if x.dtype == torch.float32 else x


# the two media: "thin" a wide box of low density (chains of tens to
# hundreds of null collisions: rounds repeat), "dense" a unit box
# near its majorant everywhere (the first step mostly accepts)
MEDIA = {
    "thin": dict(box=((-2.0, -0.5, -0.5), (2.0, 0.5, 0.5)), scale=40.0,
                 density=lambda b: 0.03 * b),
    "dense": dict(box=((-0.5, -0.5, -0.5), (0.5, 0.5, 0.5)), scale=40.0,
                  density=lambda b: 0.85 + 0.15 * b),
}


def scenes(medium):
    """The medium's scene built by JAX and carried across with convert."""
    spec = MEDIA[medium]
    dens = spec["density"](procedural.blob_volume()).astype(np.float32)
    albedo = np.stack([dens, 0.5 * np.ones_like(dens), 1.0 - dens], axis=-1)
    lo, hi = spec["box"]
    js = jtypes.make_scene(jtypes.make_medium(
        dens, albedo, box_min=lo, box_max=hi, scale=spec["scale"],
        max_density=1.0))
    m = js.medium
    ts = convert.scene_from_arrays(
        m.density.data, m.albedo.data, m.albedo_affine, m.box_min,
        m.box_max, m.scale, m.max_density, m.g, js.bsdf.roughness,
        js.bsdf.eta, js.le,
    )
    return ts, js


@pytest.fixture(scope="module", params=list(MEDIA))
def medium(request):
    return (request.param, *scenes(request.param))


def lanes(medium, n, seed):
    """n lanes from random points in the medium's box (a few outside it)
    in random directions: o, d and their (seed, lane) streams."""
    lo, hi = (np.asarray(x, np.float32) for x in MEDIA[medium]["box"])
    rs = np.random.RandomState(seed)
    o = (lo + (hi - lo) * rs.uniform(-0.05, 1.05, (n, 3))).astype(np.float32)
    d = rs.normal(size=(n, 3))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    return torch.tensor(o), torch.tensor(d), trng.make_rng(
        seed, torch.arange(n, dtype=torch.int64))


def track_args(ts, n, seed, medium):
    """woodcock_track's arguments for lanes inside the box, each tracked to
    its exit face, as bounce_step calls it."""
    m = ts.medium
    o, d, rng = lanes(medium, n, seed)
    isect = aabb.aabb_intersect(m.box_min, m.box_max, o, d)
    active = isect.hit & isect.inside_volume
    return (m.density, m.box_min, m.box_max, m.scale, m.max_density, o, d,
            isect.dist, rng, active)


@pytest.mark.parametrize("G", [1, 4, 8, 16, 32])
def test_schedule_equals_woodcock_track(medium, G):
    """The model gives woodcock_track's t, events and PCG state bit for bit
    and each lane's steps (its rows in the eager loop's per-step taps); on
    the thin medium chains run past 64 steps (rounds repeat), on the dense
    one most chains stop at their first step."""
    name, ts, _ = medium
    args = track_args(ts, 384, 11, name)
    taps, stats = [], {}
    want = twood.woodcock_track(*args, taps=taps)
    got = lookahead_track(*args, G=G, stats=stats)
    assert torch.equal(bits(got.t), bits(want.t))
    assert torch.equal(got.scattered, want.scattered)
    assert torch.equal(got.rng.state, want.rng.state)
    assert int(got.n_steps) == int(want.n_steps) > 1
    steps = stats["steps"]
    running = [int(x.shape[0]) for kind, x in taps if kind == "density"]
    for k, rows in enumerate(running):  # lanes still running at step k
        assert int((steps > k).sum()) == rows, k
    tracked = steps > 0
    if name == "thin":
        assert int(want.n_steps) > 2 * MAX_G
        if G > 1:
            assert bool((stats["rounds"][tracked] >= 3).any())
    else:
        assert float((steps[tracked] == 1).float().mean()) > 0.5


@pytest.mark.parametrize("G", [1, 8, 32])
def test_schedule_equals_jax_woodcock_track(medium, G):
    """The model against the JAX package's woodcock_track on the same
    inputs: events, PCG state and the longest lane's steps exactly, t to
    XLA's logf (as tests/test_torch_sched_ops.py holds the eager loop)."""
    name, ts, js = medium
    args = track_args(ts, 256, 5, name)
    o, d, max_t, rng, active = (args[5], args[6], args[7], args[8],
                                args[9])
    jm = js.medium
    want = jax.jit(jwood.woodcock_track, static_argnums=(10,))(
        jm.density, jm.box_min, jm.box_max, jm.scale, jm.max_density,
        jnp.asarray(o.numpy()), jnp.asarray(d.numpy()),
        jnp.asarray(max_t.numpy()),
        jrng.RngState(jnp.asarray(rng.state.numpy().astype(np.uint32)),
                      jnp.asarray(rng.inc.numpy().astype(np.uint32))),
        jnp.asarray(active.numpy()), "trilinear")
    got = lookahead_track(*args, G=G)
    np.testing.assert_array_equal(got.scattered.numpy(),
                                  np.asarray(want.scattered))
    np.testing.assert_allclose(got.t.numpy(), np.asarray(want.t),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(
        got.rng.state.numpy(), np.asarray(want.rng.state).astype(np.int64))
    assert int(got.n_steps) == int(want.n_steps) > 1


def path_state(ts, n, seed, medium):
    """A pool of n live lanes from random points in and around the box."""
    o, d, rng = lanes(medium, n, seed)
    return integrator.initial_state(o, d, rng)


@pytest.mark.parametrize("G", [1, 8, 32])
@pytest.mark.parametrize("rr", [True, False], ids=["rr", "no-rr"])
@pytest.mark.parametrize("bsdf", ["ggx", "null"])
def test_schedule_in_bounce_step_equals_bounce_step(medium, bsdf, rr, G,
                                                    monkeypatch):
    """bounce_step with the model in place of woodcock_track (its events,
    the boundary event, HG scatter, albedo and Russian roulette the eager
    code's) equals bounce_step in every field and n_rays bit for bit, over
    three bounces."""
    name, ts, _ = medium
    settings = RenderSettings.from_flags(True, bsdf_kind=bsdf,
                                         russian_roulette=rr)
    s = path_state(ts, 192, 3, name)
    plain = twood.woodcock_track
    for bounce in range(3):
        want = integrator.bounce_step(ts, settings, s)
        monkeypatch.setattr(twood, "woodcock_track", lambda *a, **k:
                            lookahead_track(*a, G=G, **k))
        got = integrator.bounce_step(ts, settings, s)
        monkeypatch.setattr(twood, "woodcock_track", plain)
        for field in ("o", "d", "throughput", "radiance", "alive", "n_rays"):
            assert torch.equal(bits(getattr(got, field)),
                               bits(getattr(want, field))), (bounce, field)
        assert torch.equal(got.rng.state, want.rng.state), bounce
        s = want
        if not bool(s.alive.any()):
            break


def test_width_rule_picks_a_built_group():
    """familybody.lookahead's (G, M) for pools of 1 to 2^20 lanes: G one of
    the groups csrc/familybody.cu builds, M lanes a power of two dividing
    it."""
    for width in [1, 100, 4096, 8192, 16384, 32768, 65536, 131072, 160000,
                  196608, 262144, 1 << 20]:
        g, m = fam.lookahead(width)
        assert g in fam.GROUPS and 1 <= m <= g and g % m == 0, width
        assert m & (m - 1) == 0, width
