"""The brickSK tracking kernel's host side and plain torch version
(ops/tracking.py) against the JAX package's Pallas kernel
(ops/pallas/tracking.py: build_dilated_bricks, and track_rows in
interpret mode on the CPU).  tests/test_torch_cuda.py holds the CUDA
kernel against the plain version on the card.

The JAX kernel takes each row's table as two gathered (R, 128) rows and
19 separate (R, 128) inputs; the port takes the shared (NB, 256) table
with a per-row brick index and stacked inputs.  Integer outputs (status,
tap, PCG state) must be equal on at least 99% of lanes, and t allclose
(rtol 1e-5, atol 1e-6) on those lanes: the libraries' float32 log may
differ by an ulp, which moves t by an ulp and could in rare cases move a
tap or an exit by one step."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cudavolumerenderer_tpu.ops.pallas import tracking as jtk
from cudavolumerenderer_tpu_torch.ops import tracking as ttk

torch.set_num_threads(2)

RTOL, ATOL = 1e-5, 1e-6


def sparse_grid(shape=(13, 17, 21), seed=0):
    """A grid on which lanes take many steps per brick and rarely accept:
    every status occurs after 1, 8 and 32 steps (rand**8, scale 1000)."""
    return (np.random.RandomState(seed).rand(*shape) ** 8).astype(np.float32)


def kernel_inputs(n_rows, seed, scale=1000.0):
    tables, major = ttk.build_dilated_bricks(torch.tensor(sparse_grid()))
    row_brick, f, rng, status = ttk.random_track_state(
        major, n_rows, seed=seed, scale=scale
    )
    return tables, row_brick, f, rng, status


def run_jax(tables, row_brick, f, rng, status, n_steps):
    outs = jtk.track_rows(
        jnp.asarray(tables.numpy()[row_brick.numpy()]),
        *[jnp.asarray(x) for x in f.numpy()],
        jnp.asarray(rng[0].numpy().astype(np.uint32)),
        jnp.asarray(rng[1].numpy().astype(np.uint32)),
        jnp.asarray(status.numpy()),
        n_steps=n_steps, interpret=True,
    )
    t, st, tap, state = [np.asarray(o) for o in outs]
    return t, st, tap, state.astype(np.int64)


@pytest.mark.parametrize("shape", [(13, 17, 21), (16, 16, 32), (9, 4, 40)])
def test_build_dilated_bricks_bit_equal(shape):
    d = np.random.RandomState(sum(shape)).rand(*shape).astype(np.float32)
    j_tab, j_major = jtk.build_dilated_bricks(d)
    t_tab, t_major = ttk.build_dilated_bricks(torch.tensor(d))
    assert t_tab.shape == j_tab.shape and t_major.shape == j_major.shape
    np.testing.assert_array_equal(t_tab.numpy(), np.asarray(j_tab))
    np.testing.assert_array_equal(t_major.numpy(), np.asarray(j_major))


@pytest.mark.parametrize("n_steps", [1, 8, 32])
def test_track_steps_matches_pallas_interpret(n_steps):
    n_rows = {1: 4, 8: 6, 32: 8}[n_steps]
    tables, row_brick, f, rng, status = kernel_inputs(n_rows, seed=n_steps)
    got = [x.numpy() for x in ttk.track_steps(
        tables.reshape(-1, ttk.ROW), row_brick, f, rng, status, n_steps)]
    want = run_jax(tables, row_brick, f, rng, status, n_steps)
    (gt, gs, gtap, gst), (wt, ws, wtap, wst) = got, want
    agree = (gs == ws) & (gtap == wtap) & (gst == wst)
    # an exit taken by both with the other code: EXIT_BRICK vs EXIT_BOX
    # where the box and brick exits coincide (the exit code depends only
    # on the inputs here, so this count is 0)
    exits = [ttk.EXIT_BRICK, ttk.EXIT_BOX]
    fv = f.numpy()
    coincident = (
        ~agree & np.isin(gs, exits) & np.isin(ws, exits) & (gst == wst)
        & np.isclose(fv[ttk.F_MAXT], fv[ttk.F_BEXIT], rtol=RTOL, atol=ATOL)
    )
    ok = agree | coincident
    counts = np.bincount(gs.ravel(), minlength=5)
    print(f"K={n_steps}: lanes differing {int((~agree).sum())} of "
          f"{agree.size} ({int(coincident.sum())} by a coincident exit); "
          f"RUNNING/SCATTER/EXIT_BRICK/EXIT_BOX/other = {counts.tolist()}")
    assert ok.mean() >= 0.99
    np.testing.assert_allclose(gt[ok], wt[ok], rtol=RTOL, atol=ATOL)
    # the states cover every outcome, including lanes still running
    assert (counts[:4] > 0).all(), counts
    # lanes that were not RUNNING on entry come back untouched
    idle = status.numpy() != ttk.RUNNING
    assert idle.any()
    np.testing.assert_array_equal(gt[idle], fv[ttk.F_T][idle])
    np.testing.assert_array_equal(gs[idle], status.numpy()[idle])
    np.testing.assert_array_equal(gst[idle], rng[0].numpy()[idle])
    assert (gtap[idle] == 0).all()
    # a scatter reports a tap inside the 225-entry dilated table
    scat = gs == ttk.SCATTER
    assert ((gtap[scat] >= 0) & (gtap[scat] < 225)).all()


def test_run_track_steps_uses_plain_version_on_cpu():
    tables, row_brick, f, rng, status = kernel_inputs(4, seed=5)
    tab = tables.reshape(-1, ttk.ROW)
    launches = ttk.KERNEL.launches
    for a, b in zip(ttk.run_track_steps(tab, row_brick, f, rng, status, 8),
                    ttk.track_steps(tab, row_brick, f, rng, status, 8)):
        assert torch.equal(a, b)
    assert ttk.KERNEL.launches == launches
