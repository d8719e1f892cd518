"""The render kernels' byte counts, on the CPU.

ops/tailpk.tail_bytes and ops/tracking.track_bytes give the least bytes
one call of the tail kernel and of the tracking kernel must move, from
which chip_smoke.py prints each kernel's bound.  They are held against
counts made by hand from the kernels' argument lists, at the shapes the
main paths use (tailpk: R = 128 and 4,096 paths; tracking: R = 1,250 rows
of the brickSK slice) and at a small shape.  The table words are
data-dependent; the plain versions report them through `taps=`, which
must leave their results unchanged.
"""

import pytest
import torch

from cudavolumerenderer_tpu_torch.ops import tailpk, tracking
from test_torch_cuda import kernel_inputs, track_inputs

# tailpk per path: reads f 17 x 4 + i 5 x 4 + rng 2 x 8 + brick 8 = 112 B,
# writes f_out 17 x 4 + i_out 2 x 4 + rng_out 8 = 84 B; params 22 x 4 B.
TAIL_CASES = [(128, 0, 25_176), (4096, 0, 802_904), (3, 10, 3 * 196 + 88 + 40)]
# tracking per row: row_brick 8 B; per lane reads f 14 x 4 + rng 2 x 8 +
# status 4 = 76 B, writes t 4 + status 4 + tap 4 + rng 8 = 20 B.
TRACK_CASES = [(1250, 0, 15_370_000), (2, 7, 2 * 12_296 + 28)]


@pytest.mark.parametrize("n_paths, words, want", TAIL_CASES)
def test_tail_bytes_match_hand_count(n_paths, words, want):
    assert tailpk.tail_bytes(n_paths, words) == want


@pytest.mark.parametrize("n_rows, words, want", TRACK_CASES)
def test_track_bytes_match_hand_count(n_rows, words, want):
    assert tracking.track_bytes(n_rows, words) == want


def test_tail_taps_leave_the_result_unchanged():
    tab, brick, params, f, i, rng = kernel_inputs(64, seed=5)
    want = tailpk.tail_steps(tab, brick, params, f, i, rng, 8)
    taps = []
    got = tailpk.tail_steps(tab, brick, params, f, i, rng, 8, taps=taps)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    pos = torch.cat(taps)
    assert len(taps) == 8 and pos.numel() > 0
    # every tap lies in its path's own brick window
    assert ((pos // tailpk.TROW)[:, None] == brick[None, :]).any(1).all()
    assert int((pos % tailpk.TROW).max()) < tailpk.TVOX


def test_track_taps_leave_the_result_unchanged():
    tables, row_brick, f, rng, status = track_inputs(3, seed=4, device="cpu")
    want = tracking.track_steps(tables, row_brick, f, rng, status, 8)
    taps = []
    got = tracking.track_steps(tables, row_brick, f, rng, status, 8, taps=taps)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    pos = torch.cat(taps)
    assert len(taps) == 8 and pos.numel() > 0
    assert ((pos // tracking.ROW)[:, None] == row_brick[None, :]).any(1).all()
    dz, dy, dx = tracking.DILATED
    assert int((pos % tracking.ROW).max()) < dz * dy * dx
