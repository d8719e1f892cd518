"""The torch port's physics primitives against the JAX package's, on the
same inputs and the same draws: values allclose (rtol 1e-5; atol 1e-6
for values near zero, where float32 rounding of sin/cos/atan2 in two
libraries differs by an ulp), branch and validity masks equal, and RNG
states equal after every call."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cudavolumerenderer_tpu.models import integrator as jint
from cudavolumerenderer_tpu.ops import aabb as jaabb
from cudavolumerenderer_tpu.ops import camera as jcam
from cudavolumerenderer_tpu.ops import ggx as jggx
from cudavolumerenderer_tpu.ops import math3 as jm3
from cudavolumerenderer_tpu.ops import phase as jphase
from cudavolumerenderer_tpu.ops import rng as jrng
from cudavolumerenderer_tpu.scene import types as jtypes
from cudavolumerenderer_tpu_torch import convert
from cudavolumerenderer_tpu_torch.models import integrator as tint
from cudavolumerenderer_tpu_torch.ops import aabb as taabb
from cudavolumerenderer_tpu_torch.ops import camera as tcam
from cudavolumerenderer_tpu_torch.ops import ggx as tggx
from cudavolumerenderer_tpu_torch.ops import math3 as tm3
from cudavolumerenderer_tpu_torch.ops import phase as tphase
from cudavolumerenderer_tpu_torch.ops import rng as trng
from cudavolumerenderer_tpu_torch.scene import types as ttypes

torch.set_num_threads(2)

RTOL, ATOL = 1e-5, 1e-6
N = 2048


def close(t, j):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=RTOL, atol=ATOL)


def same(t, j):
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def rngs(seed, n=N):
    pid = np.arange(n, dtype=np.int64) * 7 + 3
    return (
        trng.make_rng(seed, torch.tensor(pid)),
        jrng.make_rng(np.uint32(seed), jnp.asarray(pid.astype(np.uint32))),
    )


def same_rng(t_st, j_st):
    np.testing.assert_array_equal(
        t_st.state.numpy(), np.asarray(j_st.state).astype(np.int64)
    )


def unit(rs, n=N):
    v = rs.normal(size=(n, 3))
    return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)


def test_aabb_intersect_and_tie_break():
    rs = np.random.RandomState(0)
    o = rs.uniform(-1.5, 1.5, (N, 3)).astype(np.float32)
    d = unit(rs)
    # axis-aligned and corner rays exercise the normal pick order
    d[:64] = np.eye(3, dtype=np.float32)[rs.randint(0, 3, 64)] * rs.choice(
        [-1.0, 1.0], (64, 1)
    ).astype(np.float32)
    o[64:96] = 0.0
    d[64:96] = np.float32(1.0 / np.sqrt(3.0)) * rs.choice([-1.0, 1.0], (32, 3))
    bmin = np.array([-0.5, -0.4, -0.6], np.float32)
    bmax = np.array([0.6, 0.5, 0.4], np.float32)
    got = taabb.aabb_intersect(
        torch.tensor(bmin), torch.tensor(bmax), torch.tensor(o), torch.tensor(d)
    )
    want = jaabb.aabb_intersect(
        jnp.asarray(bmin), jnp.asarray(bmax), jnp.asarray(o), jnp.asarray(d)
    )
    same(got.hit, want.hit)
    same(got.inside_volume, want.inside_volume)
    same(got.normal, want.normal)
    close(got.dist, want.dist)


@pytest.mark.parametrize("res", [(16, 16), (24, 10)])
def test_generate_rays(res):
    rs = np.random.RandomState(1)
    t_st, j_st = rngs(5)
    active = rs.uniform(size=N) < 0.7
    pix = rs.uniform(0, res[0], (N, 2)).astype(np.float32)
    t_cam = tcam.make_camera(*res, device="cpu")
    j_cam = jcam.make_camera(*res)
    same(t_cam.inv_view, j_cam.inv_view)
    same(t_cam.raster_to_view, j_cam.raster_to_view)
    to, td, t_st = tcam.generate_rays(
        t_cam, torch.tensor(pix), res, t_st, torch.tensor(active)
    )
    jo, jd, j_st = jcam.generate_rays(
        j_cam, jnp.asarray(pix), res, j_st, jnp.asarray(active)
    )
    close(to, jo)
    close(td, jd)
    same_rng(t_st, j_st)


def test_look_at_matches_make_camera():
    t_cam = tcam.make_camera_look_at((0, 0, 100), (0, 0, 0), (0, 1, 0), 8, 8,
                                     0.7, device="cpu")
    j_cam = jcam.make_camera_look_at((0, 0, 100), (0, 0, 0), (0, 1, 0), 8, 8, 0.7)
    close(t_cam.inv_view, j_cam.inv_view)


@pytest.mark.parametrize("g", [0.0, 0.5, -0.3])
def test_sample_phase(g):
    rs = np.random.RandomState(2)
    d = unit(rs)
    active = rs.uniform(size=N) < 0.5
    t_st, j_st = rngs(11)
    tdir, t_st = tphase.sample_phase(
        torch.tensor(d), torch.tensor(g), t_st, torch.tensor(active)
    )
    jdir, j_st = jphase.sample_phase(
        jnp.asarray(d), jnp.float32(g), j_st, jnp.asarray(active)
    )
    close(tdir, jdir)
    same_rng(t_st, j_st)


def test_frame_from_z():
    z = unit(np.random.RandomState(3))
    for t, j in zip(tm3.frame_from_z(torch.tensor(z)),
                    jm3.frame_from_z(jnp.asarray(z))):
        close(t, j)


@pytest.mark.parametrize("mitsuba", [True, False])
@pytest.mark.parametrize("eta", [1.05 / 1.01, 1.0])
def test_ggx_sample(mitsuba, eta):
    rs = np.random.RandomState(4)
    wi = unit(rs)
    wi[:8, :2] = 0.0  # normal incidence (the slope sampler's special case)
    wi[:8, 2] = np.sign(rs.normal(size=8))
    active = rs.uniform(size=N) < 0.8
    rough = np.array([0.1, 0.1], np.float32) if mitsuba else np.array(
        [0.2, 0.05], np.float32
    )
    t_st, j_st = rngs(13)
    two, tw, tv, t_st = tggx.ggx_sample(
        torch.tensor(rough), torch.tensor(eta, dtype=torch.float32),
        torch.tensor(wi), t_st, torch.tensor(active), mitsuba_comparable=mitsuba,
    )
    jwo, jw, jv, j_st = jggx.ggx_sample(
        jnp.asarray(rough), jnp.float32(eta), jnp.asarray(wi), j_st,
        jnp.asarray(active), mitsuba_comparable=mitsuba,
    )
    same(tv, jv)
    close(two, jwo)
    close(tw, jw)
    same_rng(t_st, j_st)


def _scenes():
    dens = np.random.RandomState(5).rand(4, 4, 4).astype(np.float32)
    js = jtypes.make_scene(jtypes.make_medium(dens, 0.8), roughness=(0.2, 0.1))
    m = js.medium
    ts = convert.scene_from_arrays(
        m.density.data, m.albedo.data, None, m.box_min, m.box_max, m.scale,
        m.max_density, m.g, js.bsdf.roughness, js.bsdf.eta, js.le,
    )
    return ts, js


@pytest.mark.parametrize("bsdf", ["ggx", "null"])
def test_boundary_event(bsdf):
    rs = np.random.RandomState(6)
    normal = np.eye(3, dtype=np.float32)[rs.randint(0, 3, N)] * rs.choice(
        [-1.0, 1.0], (N, 1)
    ).astype(np.float32)
    d = unit(rs)
    o = rs.uniform(-0.5, 0.5, (N, 3)).astype(np.float32)
    tput = rs.uniform(0.1, 1.0, (N, 3)).astype(np.float32)
    mask = rs.uniform(size=N) < 0.6
    ts, js = _scenes()
    t_set = ttypes.RenderSettings.from_flags(True, bsdf_kind=bsdf)
    j_set = jtypes.RenderSettings.from_flags(True, bsdf_kind=bsdf)
    t_st, j_st = rngs(17)
    to, td, tt, t_st = tint.boundary_event(
        ts, t_set, torch.tensor(normal), torch.tensor(o), torch.tensor(d),
        torch.tensor(tput), t_st, torch.tensor(mask),
    )
    jo, jd, jt, j_st = jint.boundary_event(
        js, j_set, jnp.asarray(normal), jnp.asarray(o), jnp.asarray(d),
        jnp.asarray(tput), j_st, jnp.asarray(mask),
    )
    close(to, jo)
    close(td, jd)
    close(tt, jt)
    same_rng(t_st, j_st)


def test_russian_roulette():
    rs = np.random.RandomState(8)
    tput = rs.uniform(0.0, 1.5, (N, 3)).astype(np.float32)
    alive = rs.uniform(size=N) < 0.9
    mask = rs.uniform(size=N) < 0.7
    t_st, j_st = rngs(19)
    tt, ta, tk, t_st = tint.russian_roulette(
        torch.tensor(tput), torch.tensor(alive), t_st, torch.tensor(mask)
    )
    jt, ja, jk, j_st = jint.russian_roulette(
        jnp.asarray(tput), jnp.asarray(alive), j_st, jnp.asarray(mask)
    )
    same(tk, jk)
    same(ta, ja)
    close(tt, jt)
    same_rng(t_st, j_st)
    assert tk.any() and (~tk & torch.tensor(mask)).any()
