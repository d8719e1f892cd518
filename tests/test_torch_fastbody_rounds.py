"""fastSK's drain in rounds (csrc/fastbody.cu drain_kernel) on the CPU.

On the card the last stage's drain runs each lane a thread a lane for its
first DRAIN_SPLIT evaluations, then takes the lanes left by a warp each
(G = DRAIN_GROUP = 32 threads) in rounds of up to G evaluations: a null run (member m jumps to draw
3 m + 1, forms t_m as the eager loop's left-to-right sum, taps and tests;
the first crossing or acceptance ends it, a transit taken with it), a
chain (every member follows the path through its segment starts, probes,
transits and scatters with every tap assumed to accept; then the members
tap at once, the first rejected tap is taken as a null step, and a
throughput chain carries tp through the albedos, the cap and Russian
roulette), or one evaluation as the eager body runs it.  The kernel
cannot run here, so this file holds:

- the PCG jump table against the JAX package's sequential draws, W draws
  a step for W = 3 (a null step), 5 and 6 (a scatter without and with
  Russian roulette), up to 32 members;
- a plain torch model of those rounds (`rounds_drain`), which must equal
  the port's eager body evaluation by evaluation, bit for bit: every lane
  field and its PCG state at the end of each of its rounds, and each
  evaluation's segment-start and tracking flags, for the kernel's G 32
  and, as the model's extra coverage of how rounds end, G 1, 8 and 16, in
  config 2's modes (two- and single-level, GGX and the null boundary,
  Russian roulette on and off, f32 and packed tables, an affine and a
  constant albedo) on a small seeded medium;
- the tables the rounds read (fastbody.round_tables: each brick's inverse
  majorant, each axis's brick planes) against the eager probe's values;
- a render whose last stage drains through the model, against JAX's
  render_tile (assert_matches_jax).
tests/test_torch_cuda.py holds the kernel against the eager loop on the
card.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cudavolumerenderer_tpu.ops import rng as jrng
from cudavolumerenderer_tpu_torch.constants import EPSILON
from cudavolumerenderer_tpu_torch.models import fast as tfast
from cudavolumerenderer_tpu_torch.models import integrator
from cudavolumerenderer_tpu_torch.ops import aabb, phase
from cudavolumerenderer_tpu_torch.ops import fastbody as fb
from cudavolumerenderer_tpu_torch.ops import rng as trng
from cudavolumerenderer_tpu_torch.ops.rng import RngState
from cudavolumerenderer_tpu_torch.scene import types as ttypes
from test_torch_cuda import clone_state
from test_torch_fast_options import (
    CASCADE, assert_matches_jax, medical, render_pair, scene_pair,
)
from test_torch_fastbody import stage_render

from cudavolumerenderer_tpu.scene import procedural

torch.set_num_threads(2)

M32 = 0xFFFFFFFF
MAX_G = 32  # the kernel's largest group: a warp a lane
NEXT_CHAIN, NEXT_NULL, NEXT_ONE = 0, 1, 2  # csrc/fastbody.cu NEXT_*


@pytest.mark.parametrize("w", [3, 5, 6])
def test_jump_table_equals_sequential_draws(w):
    """A_m * s + G_m * inc is the JAX PCG state after m draws: member j of
    a 32-thread group starts its step at draw W j + 1 and ends it at
    W (j + 1)."""
    n = w * MAX_G + 1
    table = trng.jump_constants(n).numpy().astype(np.uint64)
    assert table.shape == (2, n + 1)
    rs = np.random.RandomState(w)
    state = rs.randint(0, 1 << 32, 128, dtype=np.int64)
    state[:2] = (0, M32)
    inc = rs.randint(0, 1 << 31, 128, dtype=np.int64) * 2 + 1
    st = jrng.RngState(jnp.asarray(state.astype(np.uint32)),
                       jnp.asarray(inc.astype(np.uint32)))
    s, c = state.astype(np.uint64), inc.astype(np.uint64)
    starts = {w * j + 1 for j in range(MAX_G)} | {w * j for j in
                                                   range(1, MAX_G + 1)}
    for m in range(n + 1):
        if m in starts:
            jumped = (table[0, m] * s + table[1, m] * c) & M32
            np.testing.assert_array_equal(
                jumped, np.asarray(st.state).astype(np.uint64),
                err_msg=f"m = {m}")
        _, st = jrng.next_float(st)


# -- the model ------------------------------------------------------------------

def mul32(a, b):
    """(a * b) mod 2^32 for int64 tensors of uint32 words."""
    return (a * (b & 0xFFFF) + (((a * (b >> 16)) & 0xFFFF) << 16)) & M32


def pcg_next(state, inc):
    return (mul32(state, torch.tensor(trng._MULT)) + inc) & M32


def pcg_bits(state):
    word = mul32((state >> ((state >> 28) + 4)) ^ state,
                 torch.tensor(277803737))
    return (word >> 22) ^ word


def uniform(state):
    """The float a draw that lands on `state` returns (rng.next_float)."""
    return (pcg_bits(state) >> 8).to(torch.float32) * (1.0 / (1 << 24))


def flight(u, inv_sig):
    return -torch.log(torch.clamp(u, min=EPSILON)) * inv_sig


class Medium:
    """What a stage's evaluations read, from its kernel context as
    render_tile computed it (float32 tensors, as the eager body uses)."""

    def __init__(self, ctx, scene, settings):
        f, i = ctx.fparams, ctx.iparams
        t = lambda a, b: torch.tensor(f[a:b])  # noqa: E731
        self.scene, self.settings, self.plain = scene, settings, ctx.plain
        self.ctx = ctx
        self.bmin, self.bmax = t(fb.FP_BMIN, fb.FP_BMIN + 3), t(
            fb.FP_BMAX, fb.FP_BMAX + 3)
        self.ext, self.rm1 = t(fb.FP_EXT, fb.FP_EXT + 3), t(
            fb.FP_RM1, fb.FP_RM1 + 3)
        self.scale = torch.tensor(f[fb.FP_SCALE])
        self.inv_sigmat = torch.tensor(f[fb.FP_INV_SIGMAT])
        self.epsw = torch.tensor(f[fb.FP_EPSW])
        self.bsize = t(fb.FP_BSIZE, fb.FP_BSIZE + 3)
        self.n = [int(i[fb.IP_NX]), int(i[fb.IP_NY]), int(i[fb.IP_NZ])]
        self.hi = torch.tensor([int(i[fb.IP_HIX]), int(i[fb.IP_HIY]),
                                int(i[fb.IP_HIZ])])
        self.nbx, self.nby = int(i[fb.IP_NBX]), int(i[fb.IP_NBY])
        self.two = bool(i[fb.IP_TWO_LEVEL])
        self.spp, self.maxpath = int(i[fb.IP_SPP]), int(i[fb.IP_MAXPATH])
        self.rr = bool(i[fb.IP_RR])
        self.bits = int(i[fb.IP_BITS]) if i[fb.IP_TABLE] == fb.TAB_PACKED \
            else 32
        self.table, self.btab = ctx.table, ctx.brick_tab
        assert i[fb.IP_TABLE] != fb.TAB_ROWS and not i[fb.IP_BRICK_MAJOR]

    def rho(self, o, d, t, bits):
        """The tap's flat index and density at o + t d (render_tile's
        tap_flat and fused_take; any leading shape)."""
        p = o + t[..., None] * d
        coord = torch.clamp((p - self.bmin) / self.ext, 0.0, 1.0) * self.rm1
        tap = tfast._stochastic_tap(coord, bits)
        nx, ny, nz = self.n
        flat = ((torch.clamp(tap[..., 2], 0, nz - 1) * ny
                 + torch.clamp(tap[..., 1], 0, ny - 1)) * nx
                + torch.clamp(tap[..., 0], 0, nx - 1))
        if self.bits == 32:
            return flat, self.table[flat]
        med = self.scene.medium
        return flat, tfast.packed_take(self.table, flat, med.max_density,
                                       self.bits)

    def probe(self, o, d, t):
        """render_tile's two-level probe at t: (brick exit, inverse
        majorant, majorant)."""
        p_now = o + (t + self.epsw)[:, None] * d
        coordn = torch.clamp((p_now - self.bmin) / self.ext, 0.0, 1.0) \
            * self.rm1
        bi = torch.minimum(torch.clamp(
            torch.floor(coordn / self.bsize).to(torch.int64), min=0), self.hi)
        bflat = (bi[:, 2] * self.nby + bi[:, 1]) * self.nbx + bi[:, 0]
        rho_b = self.btab[bflat][:, 0]
        up = (d > 0.0).to(torch.float32)
        bound = self.bmin + self.ext * ((bi.to(torch.float32) + up)
                                        * self.bsize) / self.rm1
        okd = torch.abs(d) > 1e-12
        t_axes = torch.where(okd, (bound - o) / torch.where(okd, d, 1.0),
                             torch.inf)
        exit_new = torch.maximum(torch.amin(t_axes, dim=-1), t + self.epsw)
        inv_new = torch.where(rho_b > 0.0, 1.0 / (
            self.scale * torch.clamp(rho_b, min=1e-30)), torch.inf)
        return exit_new, inv_new, rho_b


def take(mask, a, b):
    """Per lane `a` where mask, else `b`: a per-lane tensor, or a FastState
    (its 0-d counters `b`'s)."""
    if not isinstance(a, torch.Tensor):
        return type(a)(*(take(mask, x, y) for x, y in zip(a, b)))
    if a.ndim == 0:
        return b
    return torch.where(mask[:, None] if a.ndim == 2 else mask, a, b)


def null_run(md, s, D, G, table):
    """The null rounds of every lane of `s` (the caller masks): the state
    after them, the evaluations taken and the next round."""
    m = torch.arange(G)
    a, g = table[0][3 * m + 1], table[1][3 * m + 1]
    state, inc = s.rng.state[:, None], s.rng.inc[:, None]
    s1 = (mul32(state, a) + mul32(inc, g)) & M32
    s2 = pcg_next(s1, inc)
    s3 = pcg_next(s2, inc)
    isig = s.inv_sig_local if md.two else md.inv_sigmat.expand(s.t.shape)
    step = flight(uniform(s1), isig[:, None])
    tj = s.t[:, None].expand(-1, G)
    for i in range(G):  # left to right, -0.0 for the steps after m
        tj = tj + torch.where((i <= m)[None, :], step[:, i:i + 1], -0.0)
    if md.two:
        crossed = tj >= torch.minimum(s.brick_exit, s.max_t)[:, None]
    else:
        crossed = tj > s.max_t[:, None]
    _, rho = md.rho(s.o[:, None, :], s.d[:, None, :], tj, pcg_bits(s2))
    accepted = ~(md.scale * rho * isig[:, None] < uniform(s3))
    stop = (crossed | accepted) & (m[None, :] < D[:, None])
    has = stop.any(1)
    src = torch.where(has, stop.to(torch.int64).argmax(1), -1)
    last = torch.where(has, src - 1, D - 1)
    at = torch.clamp(last, min=0)[:, None]
    t = torch.where(last >= 0, tj.gather(1, at)[:, 0], s.t)
    rs = torch.where(last >= 0, s3.gather(1, at)[:, 0], s.rng.state)
    n = torch.where(has, src, D)
    srcc = torch.clamp(src, min=0)[:, None]
    c_src = has & crossed.gather(1, srcc)[:, 0]
    transit = c_src & md.two & ~(s.max_t <= s.brick_exit)
    t = torch.where(transit, s.brick_exit, t)
    rs = torch.where(transit, s1.gather(1, srcc)[:, 0], rs)
    n = n + transit.to(torch.int64)
    nxt = torch.where(~has, NEXT_NULL, torch.where(
        transit | (md.two & ~c_src), NEXT_CHAIN, NEXT_ONE))
    new = s._replace(t=t, rng=RngState(rs, s.rng.inc))
    return new, n, nxt, torch.zeros_like(has), torch.ones_like(has)


def chain_run(md, s, going, D, G):
    """The chain rounds of the lanes `going`: the state after them, the
    evaluations taken, the next round, and per evaluation k of the round
    its segment-start and tracking flags ((N, G))."""
    N = s.t.shape[0]
    inc = s.rng.inc
    c = s
    n = torch.zeros(N, dtype=torch.int64)
    nxt = torch.full((N,), NEXT_CHAIN)
    isect_k = torch.zeros(N, G, dtype=torch.bool)
    busy_k = torch.zeros(N, G, dtype=torch.bool)
    g = md.scene.medium.g
    for k in range(G):
        going = going & (k < D)
        if not bool(going.any()):
            break
        before = c
        # a segment start from inside the box
        seg = going & ~c.tracking
        hit = aabb.aabb_intersect(md.bmin, md.bmax, c.o, c.d)
        enters = seg & hit.hit & hit.inside_volume
        stop = seg & ~enters
        c = c._replace(
            tracking=c.tracking | enters, t=torch.where(enters, 0.0, c.t),
            max_t=torch.where(enters, hit.dist, c.max_t),
            brick_exit=torch.where(enters, -1.0, c.brick_exit),
            normal=torch.where(enters[:, None], hit.normal, c.normal))
        # the probe, not into an empty brick
        probe = going & ~stop & (c.t >= c.brick_exit)
        exit_new, inv_new, rho_b = md.probe(c.o, c.d, c.t)
        stop = stop | (probe & (rho_b <= 0.0))
        probe = probe & ~stop
        c = c._replace(
            brick_exit=torch.where(probe, exit_new, c.brick_exit),
            inv_sig_local=torch.where(probe, inv_new, c.inv_sig_local))
        # the step; an overrun is a boundary event
        s_u1 = pcg_next(c.rng.state, inc)
        t_adv = c.t + flight(uniform(s_u1), c.inv_sig_local)
        crossed = t_adv >= torch.minimum(c.brick_exit, c.max_t)
        stop = stop | (going & crossed & (c.max_t <= c.brick_exit))
        nxt = torch.where(going & stop, NEXT_ONE, nxt)
        c = take(going & stop, before, c)  # it stops before evaluation k
        going = going & ~stop
        transit = going & crossed
        stepped = going & ~crossed
        # the tap (the kernel's members test theirs at once)
        s_bits = pcg_next(s_u1, inc)
        s_u2 = pcg_next(s_bits, inc)
        _, rho = md.rho(c.o, c.d, t_adv, pcg_bits(s_bits))
        rejected = stepped & (md.scale * rho * c.inv_sig_local
                              < uniform(s_u2))
        scat = stepped & ~rejected
        # the scatter, the throughput chain, the cap and Russian roulette
        alb = tfast.fused_row_decode(md.scene, rho)[1]
        o_s = c.o + c.d * t_adv[:, None] - c.d * EPSILON
        d_s, rng = phase.sample_phase(c.d, g, RngState(s_u2, inc),
                                      active=scat)
        tput = torch.where(scat[:, None], c.throughput * alb, c.throughput)
        bounce = torch.where(scat, c.bounce + 1, c.bounce)
        capped = scat & (bounce >= md.maxpath)
        alive = c.alive & ~capped
        killed = torch.zeros_like(capped)
        if md.rr:
            tput, alive, killed, rng = integrator.russian_roulette(
                tput, alive, rng, scat & ~capped)
        died = capped | killed
        isect_k[:, k] = enters & going
        busy_k[:, k] = transit | rejected
        c = c._replace(
            o=torch.where(scat[:, None], o_s, c.o),
            d=torch.where(scat[:, None], d_s, c.d),
            throughput=tput, bounce=bounce, alive=alive,
            samples_done=torch.where(died, c.samples_done + 1,
                                     c.samples_done),
            tracking=c.tracking & ~scat,
            t=torch.where(transit, c.brick_exit,
                          torch.where(stepped, t_adv, c.t)),
            rng=RngState(torch.where(transit, s_u1, torch.where(
                rejected, s_u2, torch.where(scat, rng.state, c.rng.state))),
                inc))
        n = torch.where(going, k + 1, n)
        nxt = torch.where(rejected, NEXT_NULL, nxt)
        going = going & ~rejected & ~died
    # a lane that stopped before its round's first evaluation keeps its
    # state and goes to one evaluation
    return c, n, nxt, isect_k, busy_k


def rounds_drain(md, s, G, cap=1 << 30):
    """The drain of a last stage `s` in rounds of a group of G (the
    kernel's schedule, csrc/fastbody.cu drain_kernel): the final state,
    each lane's evaluations, its state at the end of each of its rounds
    ([(lanes, evaluations done, state)]), the per-evaluation flags
    (isect, busy: (E, N) bool) and the rounds each lane took."""
    N = s.t.shape[0]
    table = trng.jump_constants(3 * G + 1)
    j = torch.zeros(N, dtype=torch.int64)
    nxt = torch.full((N,), NEXT_CHAIN if md.two else NEXT_NULL)
    flags = {k: torch.zeros(0, N, dtype=torch.bool) for k in ("isect", "busy")}
    ends, rounds = [], torch.zeros(N, dtype=torch.int64)
    s = clone_state(s)

    def pending(x):
        return x.alive | (x.samples_done < md.spp)

    while True:
        act = pending(s) & (j < cap)
        if not bool(act.any()):
            break
        D = torch.clamp(cap - j, max=G)
        live = s.alive & (s.bounce < md.maxpath)
        can_null = live & s.tracking & (
            ~(s.t >= s.brick_exit) if md.two else True)
        null_m = act & (nxt != NEXT_ONE) & can_null & (
            (nxt == NEXT_NULL) | (not md.two))
        chain_m = act & ~null_m & (nxt != NEXT_ONE) & md.two & live
        one_m = act & ~null_m & ~chain_m
        n = torch.zeros(N, dtype=torch.int64)
        isect_k = torch.zeros(N, G, dtype=torch.bool)
        busy_k = torch.zeros(N, G, dtype=torch.bool)
        new = s
        if bool(null_m.any()):
            x, nn, nx, ik, bk = null_run(md, s, D, G, table)
            new, n = take(null_m, x, new), torch.where(null_m, nn, n)
            nxt = torch.where(null_m, nx, nxt)
            busy_k = busy_k | (null_m[:, None] & (
                torch.arange(G)[None, :] < nn[:, None]))
        if bool(chain_m.any()):
            x, nn, nx, ik, bk = chain_run(md, s, chain_m, D, G)
            new, n = take(chain_m, x, new), torch.where(chain_m, nn, n)
            nxt = torch.where(chain_m, nx, nxt)
            isect_k = isect_k | (chain_m[:, None] & ik)
            busy_k = busy_k | (chain_m[:, None] & bk)
        # a chain that took nothing goes to one evaluation next round
        if bool(one_m.any()):
            taps = []
            x = md.plain(clone_state(s), taps=taps)
            (ev,) = [v for kind, v in taps if kind == "events"]
            new, n = take(one_m, x, new), torch.where(one_m, 1, n)
            nxt = torch.where(one_m, NEXT_CHAIN if md.two else NEXT_NULL,
                              nxt)
            isect_k[:, 0] = torch.where(one_m, ev["isect"], isect_k[:, 0])
            busy_k[:, 0] = torch.where(one_m, x.tracking, busy_k[:, 0])
        # the round's evaluations at j + k, k < n
        e = j[:, None] + torch.arange(G)[None, :]
        on = act[:, None] & (torch.arange(G)[None, :] < n[:, None])
        if bool(on.any()):
            need = int(e[on].max()) + 1
            for key in flags:
                if flags[key].shape[0] < need:
                    flags[key] = torch.cat([flags[key], torch.zeros(
                        need - flags[key].shape[0], N, dtype=torch.bool)])
            lane = torch.arange(N)[:, None].expand(N, G)
            flags["isect"][e[on], lane[on]] = isect_k[on]
            flags["busy"][e[on], lane[on]] = busy_k[on]
        s = take(act, new, s)
        j = j + torch.where(act, n, 0)
        rounds = rounds + act.to(torch.int64)
        ends.append((act & (n > 0), j.clone(), clone_state(s)))
    return s, j, ends, flags, rounds


def eager_drain(md, s):
    """The eager body's drain of `s`: the state before each evaluation and
    after the last ([S_0 .. S_E]), and each evaluation's flags."""
    states, isect, busy = [clone_state(s)], [], []
    while bool((s.alive | (s.samples_done < md.spp)).any()):
        taps = []
        s = md.plain(s, taps=taps)
        (ev,) = [v for kind, v in taps if kind == "events"]
        states.append(clone_state(s))
        isect.append(ev["isect"])
        busy.append(s.tracking)
    return states, torch.stack(isect), torch.stack(busy)


LANE = ("o", "d", "throughput", "accum", "normal", "t", "max_t",
        "brick_exit", "inv_sig_local", "samples_done", "bounce", "alive",
        "tracking")


def lane_bits(x):
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def assert_lanes_equal(got, want, lanes, tag):
    for name in LANE:
        x, y = getattr(got, name)[lanes], getattr(want, name)[lanes]
        assert torch.equal(lane_bits(x), lane_bits(y)), (tag, name)
    assert torch.equal(got.rng.state[lanes], want.rng.state[lanes]), tag


#: (id, render_tile keywords, settings keywords, scene): config 2's modes
MODES = {
    "2l-ggx": (dict(two_level=True), {}, "affine"),
    "2l-null": (dict(two_level=True), dict(bsdf_kind="null"), "affine"),
    "2l-rr-off": (dict(two_level=True),
                  dict(russian_roulette=False, max_path_length=6), "affine"),
    "1l-ggx": (dict(two_level=False), {}, "affine"),
    "1l-null-rr-off": (dict(two_level=False),
                       dict(bsdf_kind="null", russian_roulette=False),
                       "affine"),
    "2l-packed8": (dict(two_level=True, table_bits=8), {}, "affine"),
    "2l-packed4-const": (dict(two_level=True, table_bits=4), {}, "const"),
}


def mode_scene(kind):
    d = procedural.medical_volume((16, 16, 16), n_blobs=4)
    if kind == "const":
        return scene_pair(d, albedo=np.full(d.shape + (3,), 0.9, np.float32),
                          scale=30.0)[0]
    return scene_pair(d, scale=30.0)[0]


_drains = {}


def mode_drain(mode):
    """The last stage of a 10^2 x 4 render in `mode` (one 100-lane pool,
    drained from its first evaluation) and its eager drain, made once."""
    if mode not in _drains:
        kw, settings_kw, kind = MODES[mode]
        scene = mode_scene(kind)
        settings = ttypes.RenderSettings.from_flags(True, **settings_kw)
        mp = pytest.MonkeyPatch()
        try:
            _, stages = stage_render(mp, scene, settings, 10, 4, **kw)
        finally:
            mp.undo()
        ctx, s, thresh, _, last = stages[-1]
        assert thresh == 0 and last
        md = Medium(ctx, scene, settings)
        _drains[mode] = (md, s, eager_drain(md, clone_state(s)))
    return _drains[mode]


#: (mode, G): every mode at the kernel's G 32 and at G 8 (rounds that end
#: four times as often), and G 1 and 16 on the two-level and the
#: single-level GGX modes: the model's extra coverage, not groups the
#: kernel builds
ROUND_CASES = [(mode, g) for mode in MODES for g in (8, 32)] + [
    (mode, g) for mode in ("2l-ggx", "1l-ggx") for g in (1, 16)]


@pytest.mark.parametrize("mode, G", ROUND_CASES,
                         ids=[f"{m}-G{g}" for m, g in ROUND_CASES])
def test_rounds_equal_the_eager_body(mode, G):
    """Every lane at the end of each of its rounds equals the eager body
    after as many evaluations, bit for bit in every field and its PCG
    state; each evaluation's segment start and tracking flag (what the
    kernel counts into n_rays and n_busy) are the eager body's; and the
    lanes take fewer rounds than evaluations once G > 1."""
    md, s, (states, isect, busy) = mode_drain(mode)
    got, j, ends, flags, rounds = rounds_drain(md, s, G)
    E = len(states) - 1
    assert int(j.max()) == E > 0
    assert_lanes_equal(got, states[-1], torch.ones_like(j, dtype=torch.bool),
                       "end")
    for lanes, at, x in ends:
        for e in torch.unique(at[lanes]).tolist():
            assert_lanes_equal(x, states[e], lanes & (at == e), (e, G))
    n_flags = flags["isect"].shape[0]
    assert n_flags <= E
    for k, v in (("isect", isect), ("busy", busy)):
        got_f = torch.zeros_like(v)
        got_f[:n_flags] = flags[k]
        for e in range(E):
            lanes = j > e  # the lane's own evaluations
            assert torch.equal(got_f[e][lanes], v[e][lanes]), (k, e)
    if G > 1:
        assert int(rounds.sum()) < int(j.sum())


def test_round_tables_equal_the_eager_probe():
    """fastbody.round_tables, which the drain's rounds read in place of a
    probe's division and its planes' arithmetic, hold the eager probe's
    inverse majorant for every brick and its brick exit planes for every
    brick index and direction sign, bit for bit."""
    md, s, _ = mode_drain("2l-ggx")
    ctx = md.ctx
    risl, planes = fb.round_tables(ctx, "cpu")
    rho_b = md.btab[:, 0]
    want = torch.where(rho_b > 0.0, 1.0 / (md.scale * torch.clamp(
        rho_b, min=1e-30)), torch.inf)
    assert torch.equal(risl, want) and bool(torch.isinf(risl).any())
    at = 0
    for a in range(3):
        n = int(md.hi[a]) + 2
        for up in (0.0, 1.0):  # a plane is bi + up: both signs of d
            bi = torch.arange(n - 1, dtype=torch.float32)
            bound = md.bmin[a] + md.ext[a] * ((bi + up) * md.bsize[a]) \
                / md.rm1[a]
            got = planes[at + (bi + up).to(torch.int64)]
            assert torch.equal(got, bound), (a, up)
        at += n
    assert at == planes.numel()
    one = ctx.iparams.copy()
    one[fb.IP_TWO_LEVEL] = 0
    assert fb.round_tables(dataclasses.replace(ctx, iparams=one),
                           "cpu") == (None, None)


def test_a_chain_covers_scatters_and_transits():
    """In the dense two-level medium a G 32 lane takes most evaluations in
    chain rounds of several evaluations, transits and scatters alike: its
    rounds are at most half its evaluations."""
    md, s, _ = mode_drain("2l-ggx")
    _, j, _, _, rounds = rounds_drain(md, s, 32)
    longest = int(torch.argmax(j))
    assert int(j[longest]) >= 2 * int(rounds[longest]) > 0


def test_render_through_the_rounds_matches_jax(monkeypatch):
    """A 24^2 x 4 two-level null-boundary render whose last stage drains
    through the model (counters folded in float32 one evaluation after
    another, as the kernel's last block folds them) equals the eager
    render bit for bit and matches JAX's render_tile."""
    pair = medical()
    kw = dict(two_level=True, **CASCADE)
    settings = ttypes.RenderSettings.from_flags(True, bsdf_kind="null")
    run = fb.run_stage
    drained = []

    def stage(ctx, s, thresh, k_chain, last):
        if not last:
            return run(ctx, s, thresh, k_chain, last)
        md = Medium(ctx, pair[0], settings)
        got, j, _, flags, _ = rounds_drain(md, s, 16)
        L = int(j.max())
        E = k_chain * -(-L // k_chain)
        rays, rows, busy = (x.numpy() for x in (s.n_rays, s.n_rows, s.n_busy))
        width = np.float32(s.alive.shape[0])
        for e in range(E):
            if e < flags["isect"].shape[0]:
                rays = np.float32(rays + np.float32(int(flags["isect"][e].sum())))
                busy = np.float32(busy + np.float32(int(flags["busy"][e].sum())))
            rows = np.float32(rows + width)
        drained.append(L)
        return got._replace(n_rays=torch.tensor(rays), n_rows=torch.tensor(rows),
                            n_busy=torch.tensor(busy)), E

    monkeypatch.setattr(fb, "route", lambda *a, **k: True)
    monkeypatch.setattr(fb, "run_stage", stage)
    t, j = render_pair(pair, **kw)
    monkeypatch.undo()
    assert drained and drained[0] > 0
    assert_matches_jax(t, j)
    eager, _ = render_pair(pair, **kw)
    for x, y in zip(t, eager):
        np.testing.assert_array_equal(x, y)
