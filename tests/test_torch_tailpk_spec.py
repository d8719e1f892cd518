"""The tail kernel's schedule (csrc/tailpk.cu) on the CPU.

The CUDA kernel runs one warp per path in rounds of two kinds.  In a null
run lane j takes draws 3j, 3j+1, 3j+2 of the path's PCG stream by
jump-ahead, forms t_j as the left-to-right sum of the round's steps, taps
and tests its step, and a ballot picks the first step that crosses or
scatters.  A scatter starts a scatter run: lane k takes step k as if steps
0..k-1 scattered and survived, starting at draw W*k (W = 6 with Russian
roulette, else 5), and a ballot picks the first link that did not.  The
kernel cannot run here, so this file holds:

- `jump_constants` against the JAX package's PCG: the jumped state equals
  m sequential draws, m = 0..192;
- a plain torch model of that schedule (both kinds of round, their
  lengths, jump-ahead draws, left-to-right t chains, the first-event
  ballots; each event step itself taken by the plain version), which must
  give `tail_steps`'s outputs bit for bit, and whose forecasts (the PCG
  state after a crossing and after each surviving scatter) must hold.
  tests/test_torch_cuda.py holds the kernel against `tail_steps` on the
  card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cudavolumerenderer_tpu.ops import rng as jrng
from cudavolumerenderer_tpu_torch.constants import EPSILON
from cudavolumerenderer_tpu_torch.ops import rng as trng
from cudavolumerenderer_tpu_torch.ops import tailpk as tpk
from test_torch_cuda import kernel_inputs, thin_inputs

torch.set_num_threads(2)

M32 = 0xFFFFFFFF


def test_jump_constants_equal_sequential_draws():
    """A_m * s + G_m * inc is the JAX PCG state after m draws, m <= 192."""
    n = 6 * tpk.LANES
    table = trng.jump_constants(n).numpy().astype(np.uint64)
    assert table.shape == (2, n + 1)
    rs = np.random.RandomState(5)
    state = rs.randint(0, 1 << 32, 512, dtype=np.int64)
    state[:2] = (0, M32)
    inc = rs.randint(0, 1 << 31, 512, dtype=np.int64) * 2 + 1
    st = jrng.RngState(jnp.asarray(state.astype(np.uint32)),
                       jnp.asarray(inc.astype(np.uint32)))
    s, c = state.astype(np.uint64), inc.astype(np.uint64)
    for m in range(n + 1):
        jumped = (table[0, m] * s + table[1, m] * c) & M32
        np.testing.assert_array_equal(jumped, np.asarray(st.state).astype(
            np.uint64), err_msg=f"m = {m}")
        _, st = jrng.next_uint32(st)


def mul32(a, b):
    """(a * b) mod 2^32 for int64 tensors of uint32 words."""
    return (a * (b & 0xFFFF) + (((a * (b >> 16)) & 0xFFFF) << 16)) & M32


def warp_schedule(tab, brick, params, f, i, rng, n_steps):
    """The kernel's schedule in plain torch, with `tail_steps`'s signature
    and outputs, plus per path the null runs that met no event.

    Null run: lane j of D = min(lanes, n_steps - done) jumps to draw 3j,
    draws u1, tap bits and u2, and forms t_j = t + step_0 + ... + step_j
    left to right.  The first lane whose step crosses or accepts is the
    event, the steps before it null collisions.  A crossing is taken (one
    `tail_steps` step); at a scatter the path moves to t_{j-1} and draw 3j
    and goes on in a scatter run.  Without an event it moves to t_{D-1}
    and draw 3D.

    Scatter run: C = min(run, n_steps - done) links, taken one step at a
    time; each link that scatters and survives must leave the state at
    draw W(k+1) of the run.  The run ends at the first link that does not;
    if none, the next run is twice as long (at most LANES)."""
    lanes = tpk.LANES
    table = trng.jump_constants(6 * lanes)

    def jump(state, inc, m):
        return (mul32(state, table[0][m]) + mul32(inc, table[1][m])) & M32

    def take_step(mask, f, i, state, t=None):
        """One plain step for the paths in `mask`, from time t if given."""
        f_in = f.clone()
        if t is not None:
            f_in[tpk.F_T] = t
        i_in = i.clone()
        i_in[tpk.I_STATUS] = torch.where(mask, i[tpk.I_STATUS], tpk.DEAD)
        return tpk.tail_steps(tab, brick, params, f_in, i_in,
                              torch.stack([state, inc]), 1)

    P = params
    W = 6 if float(P[tpk.P_RR]) > 0.5 else 5
    f, i, state, inc = f.clone(), i.clone(), rng[0].clone(), rng[1]
    R = f.shape[1]
    lane = torch.arange(lanes)
    done = torch.zeros(R, dtype=torch.int64)
    quiet = torch.zeros(R, dtype=torch.int64)
    run = torch.zeros(R, dtype=torch.int64)  # 0: the next round is a null run
    while True:
        active = (i[tpk.I_STATUS] == tpk.RUN) & (done < n_steps)
        if not active.any():
            break
        nul, sca = active & (run == 0), active & (run > 0)

        # ---- null run ------------------------------------------------------
        D = torch.clamp(n_steps - done, 1, lanes)
        st = trng.RngState(jump(state[:, None], inc[:, None], 3 * lane),
                           inc[:, None].expand(R, lanes))
        b1, st = trng.next_uint32(st)
        b2, st = trng.next_uint32(st)
        b3, st = trng.next_uint32(st)
        inv_sig = f[tpk.F_INVSIG][:, None]
        step = -torch.log(torch.clamp(tpk._uniform(b1), min=EPSILON)) * inv_sig
        t_j, acc = torch.empty_like(step), f[tpk.F_T]
        for k in range(lanes):  # left to right, as the serial loop adds
            acc = acc + step[:, k]
            t_j[:, k] = acc
        eff_exit = torch.minimum(f[tpk.F_BEXIT], f[tpk.F_MAXT])
        crossed = t_j >= eff_exit[:, None]
        local = []
        for a in range(3):
            pos = f[tpk.F_OX + a][:, None] + t_j * f[tpk.F_DX + a][:, None]
            c = torch.clamp((pos - P[tpk.P_BMINX + a]) / P[tpk.P_EXTX + a],
                            0.0, 1.0) * P[tpk.P_RM1X + a]
            u = ((b2 >> (10 * a)) & 0x3FF).to(torch.float32) * (1.0 / 1024.0)
            fl = torch.floor(c)
            tap = fl.to(torch.int64) + (u < c - fl).to(torch.int64)
            tap = torch.clamp(tap, 0, int(P[tpk.P_NX + a]) - 1)
            local.append(torch.clamp(
                tap - i[tpk.I_WX + a].to(torch.int64)[:, None], 0, tpk.TDIL - 1))
        rho = tab[brick[:, None], (local[2] * tpk.TDIL + local[1]) * tpk.TDIL
                  + local[0]]
        accepted = ~(P[tpk.P_SCALE] * rho * inv_sig < tpk._uniform(b3))
        event = (crossed | accepted) & (lane < D[:, None])
        has = event.any(1)
        first = event.to(torch.int64).argmax(1)

        # no event: all D steps were null collisions
        calm = nul & ~has
        last = t_j.gather(1, (D - 1)[:, None])[:, 0]
        f[tpk.F_T] = torch.where(calm, last, f[tpk.F_T])
        state = torch.where(calm, jump(state, inc, 3 * D), state)
        quiet = quiet + calm
        done = done + torch.where(calm, D, 0)

        # an event at lane `first`: move past the nulls before it
        cross = nul & has & crossed.gather(1, first[:, None])[:, 0]
        scat = nul & has & ~cross
        t_before = torch.where(
            first > 0, t_j.gather(1, (first - 1).clamp(min=0)[:, None])[:, 0],
            f[tpk.F_T])
        at = jump(state, inc, 3 * first)
        fo, io, so = take_step(cross, f, i, at, t_before)
        assert (io[1][cross] != tpk.RUN).all()
        assert torch.equal(so[cross], jump(state, inc, 3 * first + 1)[cross])
        f = torch.where(cross, fo, f)
        i[tpk.I_BOUNCE:] = torch.where(cross, io, i[tpk.I_BOUNCE:])
        done = done + torch.where(cross, first + 1, 0) + torch.where(
            scat, first, 0)
        f[tpk.F_T] = torch.where(scat, t_before, f[tpk.F_T])
        state = torch.where(cross, so, torch.where(scat, at, state))
        run = torch.where(scat, tpk.FIRST_RUN, run)

        # ---- scatter run ---------------------------------------------------
        C = torch.minimum(run, n_steps - done)
        base, going, k = state, sca, 0
        while going.any():
            fo, io, so = take_step(going, f, i, state)
            lived = going & (io[0] == i[tpk.I_BOUNCE] + 1) & (io[1] == tpk.RUN)
            assert torch.equal(so[lived], jump(base, inc, W * (k + 1))[lived])
            f = torch.where(going, fo, f)
            i[tpk.I_BOUNCE:] = torch.where(going, io, i[tpk.I_BOUNCE:])
            state = torch.where(going, so, state)
            done = done + going
            run = torch.where(going & ~lived, 0, run)
            k += 1
            going = lived & (k < C)
        run = torch.where(sca & (run > 0), torch.clamp(2 * run, max=lanes), run)
    return (f, i[tpk.I_BOUNCE:], state), quiet


def bits(x):
    return x.view(torch.int32) if x.dtype == torch.float32 else x


@pytest.mark.parametrize("n_steps", [1, 16, 40])
@pytest.mark.parametrize("rr", [True, False])
@pytest.mark.parametrize("medium", ["dense", "thin"])
def test_warp_schedule_equals_tail_steps(medium, rr, n_steps):
    if medium == "dense":
        inputs = kernel_inputs(64, seed=31, max_path=6 if rr else 1000, rr=rr)
    else:
        inputs = thin_inputs(64, seed=32, rr=rr)
    got, quiet = warp_schedule(*inputs, n_steps=n_steps)
    want = tpk.tail_steps(*inputs, n_steps=n_steps)
    for name, a, b in zip(("f", "bounce/status", "rng"), got, want):
        assert torch.equal(bits(a), bits(b)), name
    if medium == "thin" and n_steps > tpk.LANES:
        # K > 32: some paths go two rounds, 32 + 8 steps, with no event
        assert (quiet >= 2).any()
    if medium == "dense" and n_steps > 1:
        assert (want[1][0] != inputs[4][tpk.I_BOUNCE]).any()  # scatters
