"""The integrator family's primitives against the JAX package's on the
same inputs and draws: the grid samplers (scalar and vector grids,
clamped and truncated taps), Woodcock tracking (the host-looped
while_loop and the single masked step), the Morton keys, the density
gradient and one bounce of the shared integrator.  RNG states and Morton
keys must be bit-equal; values allclose."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cudavolumerenderer_tpu.models import integrator as jint
from cudavolumerenderer_tpu.ops import gradient as jgrad
from cudavolumerenderer_tpu.ops import grid as jgrid
from cudavolumerenderer_tpu.ops import morton as jmorton
from cudavolumerenderer_tpu.ops import rng as jrng
from cudavolumerenderer_tpu.ops import woodcock as jwood
from cudavolumerenderer_tpu.scene import procedural
from cudavolumerenderer_tpu.scene import types as jtypes
from cudavolumerenderer_tpu_torch import convert
from cudavolumerenderer_tpu_torch.models import integrator as tint
from cudavolumerenderer_tpu_torch.ops import gradient as tgrad
from cudavolumerenderer_tpu_torch.ops import grid as tgrid
from cudavolumerenderer_tpu_torch.ops import morton as tmorton
from cudavolumerenderer_tpu_torch.ops import rng as trng
from cudavolumerenderer_tpu_torch.ops import woodcock as twood
from cudavolumerenderer_tpu_torch.scene import types as ttypes

torch.set_num_threads(2)


def t(x, dtype=None):
    a = np.asarray(x)
    if a.dtype == np.uint32:
        a = a.astype(np.int64)
    out = torch.tensor(a)
    return out if dtype is None else out.to(dtype)


def rng_pair(seed, n):
    ids = np.arange(n, dtype=np.uint32)
    return jrng.make_rng(seed, jnp.asarray(ids)), trng.make_rng(seed, t(ids))


def assert_rng_equal(j, tr):
    np.testing.assert_array_equal(
        np.asarray(j.state).astype(np.int64), tr.state.numpy())
    np.testing.assert_array_equal(
        np.asarray(j.inc).astype(np.int64), tr.inc.numpy())


def scenes(scale=40.0):
    """The blob 32^3 scene with an affine RGB albedo, built by JAX and
    carried across with convert."""
    dens = procedural.blob_volume()
    albedo = np.stack([dens, 0.5 * np.ones_like(dens), 1.0 - dens], axis=-1)
    js = jtypes.make_scene(jtypes.make_medium(dens, albedo, scale=scale,
                                              max_density=1.0))
    m = js.medium
    ts = convert.scene_from_arrays(
        m.density.data, m.albedo.data, m.albedo_affine, m.box_min,
        m.box_max, m.scale, m.max_density, m.g, js.bsdf.roughness,
        js.bsdf.eta, js.le,
    )
    return ts, js


@pytest.fixture(scope="module")
def blob():
    return scenes()


# -- grid samplers -----------------------------------------------------------

GRID_SHAPES = [(9, 7, 5), (6, 5, 4, 3)]


def points(n=4000, seed=0):
    """Points in [-0.3, 1.3]^3: inside, on the faces and outside the unit
    cube, so taps clamp and negative voxel coordinates truncate toward
    zero."""
    p = np.random.RandomState(seed).uniform(-0.3, 1.3, (n, 3))
    p[:8] = [[0, 0, 0], [1, 1, 1], [1, 0, 1], [-0.01, 0.5, 0.5],
             [0.999999, 0.5, 0.5], [-1e-7, -1e-7, -1e-7], [0.5, 1.0001, 0.2],
             [0.25, 0.5, 0.75]]
    return p.astype(np.float32)


@pytest.mark.parametrize("shape", GRID_SHAPES)
@pytest.mark.parametrize("mode", ["trilinear", "nearest"])
def test_sample_matches_jax(shape, mode):
    data = np.random.RandomState(1).rand(*shape).astype(np.float32)
    p = points()
    want = np.asarray(jgrid.sample(jgrid.Grid(jnp.asarray(data)),
                                   jnp.asarray(p), mode))
    got = tgrid.sample(tgrid.Grid(t(data)), t(p), mode).numpy()
    assert got.shape == want.shape == p.shape[:1] + shape[3:]
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_nearest_truncates_toward_zero():
    """Voxel coordinate -0.5 truncates to 0, as int() does (floor would
    give -1, which clamps to 0 too); 2.9 to 2, not 3."""
    data = np.arange(4 * 4 * 4, dtype=np.float32).reshape(4, 4, 4)
    p = np.asarray([[-0.5 / 3, 0.0, 0.0], [2.9 / 3, 0.0, 0.0],
                    [0.0, 2.9 / 3, 0.0]], np.float32)
    got = tgrid.sample_nearest(tgrid.Grid(t(data)), t(p)).numpy()
    np.testing.assert_array_equal(got, [0.0, 2.0, 8.0])
    want = np.asarray(jgrid.sample_nearest(jgrid.Grid(jnp.asarray(data)),
                                           jnp.asarray(p)))
    np.testing.assert_array_equal(got, want)


def test_unknown_interpolation_raises():
    with pytest.raises(ValueError, match="interpolation"):
        tgrid.sample(tgrid.Grid(torch.zeros(2, 2, 2)), torch.zeros(1, 3),
                     "cubic")


# -- Woodcock tracking ---------------------------------------------------------

def track_inputs(n=512, seed=3):
    """Rays from random points inside the blob's box in random
    directions, each tracked to its exit face."""
    rs = np.random.RandomState(seed)
    o = rs.uniform(-0.45, 0.45, (n, 3)).astype(np.float32)
    d = rs.normal(size=(n, 3))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    max_t = rs.uniform(0.05, 0.9, n).astype(np.float32)
    active = rs.rand(n) < 0.8
    return o, d, max_t, active


@pytest.mark.parametrize("mode", ["trilinear", "nearest"])
def test_woodcock_track_matches_jax(blob, mode):
    ts, js = blob
    o, d, max_t, active = track_inputs()
    jr, tr = rng_pair(11, len(o))
    jm, tm = js.medium, ts.medium
    want = jax.jit(jwood.woodcock_track, static_argnums=(10,))(
        jm.density, jm.box_min, jm.box_max, jm.scale, jm.max_density,
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(max_t), jr,
        jnp.asarray(active), mode)
    got = twood.woodcock_track(
        tm.density, tm.box_min, tm.box_max, tm.scale, tm.max_density,
        t(o), t(d), t(max_t), tr, t(active), mode)
    np.testing.assert_array_equal(got.scattered.numpy(),
                                  np.asarray(want.scattered))
    np.testing.assert_allclose(got.t.numpy(), np.asarray(want.t),
                               rtol=1e-5, atol=1e-6)
    assert_rng_equal(want.rng, got.rng)
    assert int(got.n_steps) == int(want.n_steps) > 1
    # inactive lanes: t = 0, no event, no draw
    assert (got.t.numpy()[~active] == 0).all()
    assert not got.scattered.numpy()[~active].any()


def test_woodcock_track_ignores_check_cadence(blob):
    """Reading the running mask every step or every 7 steps gives the
    same t, events, RNG state and step count (a step with no running
    lane changes nothing)."""
    ts, _ = blob
    o, d, max_t, active = track_inputs(n=256, seed=5)
    tm = ts.medium
    out = []
    for every in (1, 7):
        _, tr = rng_pair(2, len(o))
        out.append(twood.woodcock_track(
            tm.density, tm.box_min, tm.box_max, tm.scale, tm.max_density,
            t(o), t(d), t(max_t), tr, t(active), check_every=every))
    a, b = out
    assert torch.equal(a.t, b.t) and torch.equal(a.scattered, b.scattered)
    assert torch.equal(a.rng.state, b.rng.state)
    assert int(a.n_steps) == int(b.n_steps)


def test_woodcock_step_masked_matches_jax(blob):
    ts, js = blob
    o, d, max_t, active = track_inputs(seed=8)
    t0 = np.random.RandomState(4).uniform(0.0, 0.3, len(o)).astype(np.float32)
    jr, tr = rng_pair(21, len(o))
    jm, tm = js.medium, ts.medium
    j_out = jax.jit(jwood.woodcock_step_masked)(
        jm.density, jm.box_min, jm.box_max, jm.scale, jm.max_density,
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(t0), jnp.asarray(max_t),
        jr, jnp.asarray(active))
    t_out = twood.woodcock_step_masked(
        tm.density, tm.box_min, tm.box_max, tm.scale, tm.max_density,
        t(o), t(d), t(t0), t(max_t), tr, t(active))
    np.testing.assert_allclose(t_out[0].numpy(), np.asarray(j_out[0]),
                               rtol=1e-5, atol=1e-6)
    for k in (1, 2):
        np.testing.assert_array_equal(t_out[k].numpy(), np.asarray(j_out[k]))
    assert_rng_equal(j_out[3], t_out[3])
    assert t_out[1].any() and t_out[2].any()


# -- Morton keys ---------------------------------------------------------------

def test_expand_bits_matches_jax():
    v = np.concatenate([np.arange(1024), [1023, 4095, 0xFFFFFFFF & 123456789]])
    got = tmorton.expand_bits(torch.tensor(v, dtype=torch.int64)).numpy()
    want = np.asarray(jmorton.expand_bits(jnp.asarray(v, jnp.uint32)))
    np.testing.assert_array_equal(got, want.astype(np.int64))


def test_ray_sort_keys_bit_equal():
    """Keys of points inside, on and outside the box, live and dead: the
    same 30-bit codes, and DEAD_KEY sorting after every code."""
    rs = np.random.RandomState(6)
    p = rs.uniform(-0.7, 0.7, (3000, 3)).astype(np.float32)
    p[:4] = [[-0.5, -0.5, -0.5], [0.5, 0.5, 0.5], [0.0, 0.0, 0.0],
             [0.4999, -0.5, 0.1]]
    alive = rs.rand(len(p)) < 0.7
    lo = np.asarray([-0.5, -0.5, -0.5], np.float32)
    hi = np.asarray([0.5, 0.5, 0.5], np.float32)
    got = tmorton.ray_sort_keys(t(p), t(lo), t(hi), t(alive)).numpy()
    want = np.asarray(jmorton.ray_sort_keys(
        jnp.asarray(p), jnp.asarray(lo), jnp.asarray(hi), jnp.asarray(alive)))
    np.testing.assert_array_equal(got, want.astype(np.int64))
    assert (got[~alive] == tmorton.DEAD_KEY).all()
    assert got[alive].max() < tmorton.DEAD_KEY
    # the stable sort puts the dead lanes last, in lane order
    order = torch.argsort(torch.tensor(got), stable=True).numpy()
    np.testing.assert_array_equal(order, np.argsort(want, kind="stable"))


# -- density gradient ------------------------------------------------------------

@pytest.mark.parametrize("mode", ["trilinear", "nearest"])
def test_gradient_cd_matches_jax(mode):
    data = np.random.RandomState(0).rand(16, 12, 10).astype(np.float32)
    p = points(n=500, seed=2)
    want = np.asarray(jgrad.gradient_cd(jgrid.Grid(jnp.asarray(data)),
                                        jnp.asarray(p), 0.05, mode))
    got = tgrad.gradient_cd(tgrid.Grid(t(data)), t(p), 0.05, mode).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


# -- one bounce of the shared integrator -------------------------------------------

def assert_close_mostly_equal(got, want, name):
    """Allclose at 1e-3, and 99% of the values within 1e-6.  XLA's
    sin/cos/tan/acos/atan2/log and its contracted lerps differ from
    torch's in the last bit or two (test_torch_schedulers.py measures
    it); the GGX sample's tan(acos(.)) near grazing incidence turns such
    a bit into ~1e-4 on a few directions."""
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3, err_msg=name)
    assert np.mean(np.abs(got - want) <= 1e-6 + 1e-6 * np.abs(want)) > 0.99


@pytest.mark.parametrize("boundary", ["aabb", "variable"])
def test_bounce_step_matches_jax(blob, boundary):
    """One bounce from random states: the miss, the free flight, the GGX
    boundary event, the HG scatter and Russian roulette on the same
    draws.  With the AABB boundary half the origins lie inside the box;
    with the variable boundary all lie outside it, because from inside
    the march's first test (is the exit point, pushed out by EPSILON,
    entered at t > EPSILON?) is decided by the last bit of o + d * t."""
    ts, js = blob
    n = 1024
    rs = np.random.RandomState(9)
    o = rs.uniform(-0.6, 0.6, (n, 3)).astype(np.float32)
    o[: n if boundary == "variable" else n // 2] *= 3.0  # mostly outside
    if boundary == "variable":
        o[np.all(np.abs(o) < 0.55, axis=-1), 0] = 1.5
    d = rs.normal(size=(n, 3))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    d[: n // 4] = -o[: n // 4] / np.linalg.norm(o[: n // 4], axis=-1,
                                                keepdims=True)
    tput = rs.uniform(0.2, 1.0, (n, 3)).astype(np.float32)
    alive = rs.rand(n) < 0.9
    jr, tr = rng_pair(17, n)
    kw = dict(boundary=boundary, boundary_threshold=1e-2)
    jst = jint.PathState(
        o=jnp.asarray(o), d=jnp.asarray(d), throughput=jnp.asarray(tput),
        radiance=jnp.zeros((n, 3)), alive=jnp.asarray(alive), rng=jr,
        n_rays=jnp.float32(5.0))
    tst = tint.PathState(
        o=t(o), d=t(d), throughput=t(tput), radiance=torch.zeros(n, 3),
        alive=t(alive), rng=tr, n_rays=torch.tensor(5.0))
    want = jax.jit(jint.bounce_step, static_argnums=(1,))(
        js, jtypes.RenderSettings.from_flags(True, **kw), jst)
    got = tint.bounce_step(ts, ttypes.RenderSettings.from_flags(True, **kw),
                           tst)
    np.testing.assert_array_equal(got.alive.numpy(), np.asarray(want.alive))
    assert float(got.n_rays) == float(want.n_rays) == 5.0 + alive.sum()
    for name in ("o", "d", "throughput", "radiance"):
        assert_close_mostly_equal(
            getattr(got, name).numpy(), np.asarray(getattr(want, name)), name)
    assert_rng_equal(want.rng, got.rng)
    # the bounce did all three things somewhere
    moved = np.abs(got.o.numpy() - o).max(-1) > 0
    assert moved.any() and (~got.alive.numpy() & alive).any()
    assert (got.radiance.numpy() > 0).any()
