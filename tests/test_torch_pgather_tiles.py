"""The tile kernel of vmem and binned (csrc/pgather.cu, gather_tiles) and
taa1's warp-per-row kernel on the CPU.

The CUDA kernel cannot run here, so this file models its schedule in
torch and holds the model to the plain versions:

- n = S * K lanes, shard-major as idx lies in memory (binned: S shards of
  K lanes, lane i in shard i // K; vmem: one shard of n lanes), cut into
  tiles of THREADS * LPT lanes (each kernel's shape, read from the
  source);
- a persistent grid of min(tiles, SMs x blocks per SM) blocks; block b
  walks tiles b, b + G, b + 2G, ...;
- lane p of a tile belongs to thread (p // 4) % THREADS, group
  (p // 4) // THREADS, slot p % 4; a group's shard, and so its window
  [s*C, (s+1)*C) of the table, is that of its first lane;
- on the 16-byte path (idx and out 16-byte aligned, K a multiple of 4)
  each thread copies its groups of tile k into stage k % 2 of a
  shared-memory ring, tile k + 1's copy issued before tile k is read, and
  reads back its own groups; on the scalar path the same lanes, no ring,
  each lane its own shard.

Asserted: every lane written exactly once; on the 16-byte path no group
straddles a tile or a shard, a ring stage is never refilled before its
tile was read, and a thread reads back just the groups it copied; the
model's output equals `binned_gather` / `vmem_gather` bit for bit; a lane
outside its shard reads nothing and gives NaN; at the 4.3 GB table's
shard size (arithmetic only: a stub table returns the position it is
asked for) the 64-bit offsets pass 2^32 bytes and land on the index.

taa1 (taa1_kernel): a grid of one wave of warps walks the rows, each row
once; lane t's registers hold row elements 4t .. 4t + 3 (t, t + 32, ...
on the scalar path, which unaligned inputs take); each slot of the
warp's shared-memory slice is written by one lane (lane q >> 2,
component q & 3 on the 16-byte path) and output q reads slot q, or NaN
outside the row.  The model equals `taa1_gather` for R = 1, 3, 2,048
and 2,049, on both paths.
tests/test_torch_cuda.py holds the kernels themselves on the card.
"""

import functools
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from cudavolumerenderer_tpu_torch.benchmarks import micro_pgather as mpg
from cudavolumerenderer_tpu_torch.ops import pgather as pg
from test_torch_cuda import at_4_byte_offset

torch.set_num_threads(2)

H100_SMS = 132
SOURCE = (Path(pg.__file__).resolve().parents[1] / "csrc" / "pgather.cu").read_text()


def source_shape(name):
    """(threads, lanes per thread, blocks per SM) of kernel `name`, as
    csrc/pgather.cu declares them."""
    key = name.upper()
    found = re.search(rf"constexpr int {key}_THREADS = (\d+), {key}_LPT = (\d+), "
                      rf"{key}_BLOCKS_PER_SM = (\d+);", SOURCE)
    assert found, f"no tile shape for {name} in csrc/pgather.cu"
    return tuple(map(int, found.groups()))


SHAPES = {name: source_shape(name) for name in ("vmem", "binned")}
STAGES = 2  # the ring's stages: tile k in stage k % 2


def grid_blocks(name, n, sms):
    """The launcher's persistent grid (tile_blocks in the source)."""
    threads, lpt, per_sm = SHAPES[name]
    return min(-(-n // (threads * lpt)), sms * per_sm)


@functools.cache
def lane_slots(threads, lpt):
    """(p, thread, group) of the lanes of a tile, in the kernel's order."""
    g, tid, j = torch.meshgrid(torch.arange(lpt // 4), torch.arange(threads),
                               torch.arange(4), indexing="ij")
    p = (g * threads + tid) * 4 + j
    return p.reshape(-1), tid.reshape(-1), g.reshape(-1)


def tile_schedule(name, S, K, vec, sms):
    """Walk kernel `name`'s schedule over S * K lanes; returns per lane the
    number of writes and the shard whose window it reads, checking the
    ring as it goes."""
    threads, lpt, _ = SHAPES[name]
    tl, n = threads * lpt, S * K
    G = grid_blocks(name, n, sms)
    tiles = -(-n // tl)
    p, tid, g = lane_slots(threads, lpt)
    first = p - p % 4  # a lane's group's first lane, within the tile
    writes = torch.zeros(n, dtype=torch.int64)
    shard = torch.full((n,), -1, dtype=torch.int64)
    for b in range(G):
        held = [None] * STAGES  # the tile copied into each stage, unread
        copied = {}  # tile -> the (thread, group) pairs that copied

        def stage(t, st):
            if not vec or t >= tiles:
                return
            assert held[st] is None, f"stage {st} refilled before it was read"
            held[st] = t
            heads = (p % 4 == 0) & (t * tl + p < n)  # one 16-byte copy per group
            copied[t] = set(zip(tid[heads].tolist(), g[heads].tolist()))

        stage(b, 0)
        for k, t in enumerate(range(b, tiles, G)):
            stage(t + G, (k + 1) % STAGES)
            start = t * tl
            valid = start + p < n
            lanes = start + p[valid]
            if vec:
                assert held[k % STAGES] == t, "read a stage holding another tile"
                held[k % STAGES] = None
                heads = (p % 4 == 0) & valid
                assert set(zip(tid[heads].tolist(), g[heads].tolist())) == copied.pop(t)
                assert bool((valid == (start + first < n)).all()), \
                    "a group straddles the end of the lanes"
                s = (start + first[valid]) // K
                assert bool((s == lanes // K).all()), "a group straddles two shards"
            else:
                s = lanes // K
            writes[lanes] += 1
            shard[lanes] = s
        assert all(h is None for h in held) and not copied
    return writes, shard


def model_gather(name, take, idx, S, C, vec, sms, fill):
    """The kernel's output: lane i reads take(idx[i]) where idx[i] lies in
    its shard's window [s*C, (s+1)*C), else `fill`."""
    K = idx.numel() // S
    writes, shard = tile_schedule(name, S, K, vec, sms)
    assert bool((writes == 1).all()), "a lane was written other than once"
    q = idx.reshape(-1).long()
    loc = q - shard * C
    ok = (loc >= 0) & (loc < C)
    out = torch.full((S * K,), fill, dtype=torch.float64)
    out[ok] = take(shard[ok] * C + loc[ok]).double()
    return out.reshape(idx.shape)


@functools.cache
def table(V):
    return torch.from_numpy(mpg.make_table(V))


def binned_inputs(V, S, K, rep=0):
    C = V // S
    idx = torch.from_numpy(mpg.fresh_binned(rep, S, K, C))
    return table(V), idx.view(S, K // 128, 128)


# (V, S, K): the CPU tests' small shape, the published one (67 MB, N =
# 262,144, S = 16), and K = 128, 16,256 and 16,384 lanes per shard on a
# small table (K = 128 and 16,256: tiles span shards, the last is ragged)
BINNED = {
    "small": (mpg.table_rows(0.25, 4), 4, 1024),
    "published": (mpg.table_rows(67.0, 16), 16, 16384),
    "K128": (16 * 4096, 16, 128),
    "K16256": (16 * 4096, 16, 16256),
    "K16384": (16 * 4096, 16, 16384),
}


@pytest.mark.parametrize("sms", [H100_SMS, 4])
@pytest.mark.parametrize("vec", [True, False], ids=["vec16", "scalar"])
@pytest.mark.parametrize("shape", sorted(BINNED))
def test_binned_schedule_equals_plain(shape, vec, sms):
    """Four SMs make each block walk many tiles through the ring."""
    V, S, K = BINNED[shape]
    tab, idx = binned_inputs(V, S, K)
    got = model_gather("binned", lambda pos: tab[pos], idx, S, V // S, vec,
                       sms, np.nan)
    assert torch.equal(got.float(), pg.binned_gather(tab, idx))


@pytest.mark.parametrize("sms", [H100_SMS, 4])
@pytest.mark.parametrize("n", [4096, 262144, 262148, 262147, 5])
def test_vmem_schedule_equals_plain(n, sms):
    """n = 262,148 and 262,147 are no multiple of 8 (the last tile is
    ragged); 262,147 and 5 no multiple of 4, so they take the scalar
    path, as the launcher decides."""
    Vv = mpg.VMEM_ENTRIES
    tab = table(Vv)
    idx = torch.from_numpy(mpg.fresh_idx(1, n, Vv))
    got = model_gather("vmem", lambda pos: tab[pos], idx, 1, Vv, n % 4 == 0,
                       sms, np.nan)
    assert torch.equal(got.float(), pg.vmem_gather(tab, idx))


@pytest.mark.parametrize("vec", [True, False], ids=["vec16", "scalar"])
def test_out_of_shard_lanes_read_nothing(vec):
    """A lane outside its shard gets NaN and no table read."""
    V, S, K = BINNED["K128"]
    tab, idx = binned_inputs(V, S, K)
    flat = idx.clone().view(-1)
    flat[::7] = -1
    flat[3::7] = flat[3::7] + V // S  # the next shard's window, or past V
    asked = []
    got = model_gather("binned", lambda pos: asked.append(pos) or tab[pos],
                       flat.view(idx.shape), S, V // S, vec, H100_SMS, np.nan)
    want = pg.binned_gather(tab, idx).reshape(-1).double()
    bad = torch.zeros(S * K, dtype=torch.bool)
    bad[::7] = bad[3::7] = True
    assert torch.equal(got.reshape(-1).isnan(), bad)
    assert torch.equal(got.reshape(-1)[~bad], want[~bad])
    assert torch.cat(asked).numel() == int((~bad).sum())


@pytest.mark.parametrize("sms", [H100_SMS, 4])
def test_43gb_shard_offsets_pass_2_32_bytes(sms):
    """The 4.3 GB table (V = 1,127,219,200, S = 16, K = 16,384) without
    the table: a stub returns the position the kernel asks for.  Every
    lane asks for its own index, the int32 indices and the 32-bit lane
    numbers still fit, and the byte offsets of shard 15 pass 2^32, which
    32-bit offsets would wrap."""
    S, K = 16, 16384
    V = mpg.table_rows(4300.0, S)
    C = V // S
    assert V == 1_127_219_200 and V < 2**31 and S * K < 2**32
    idx = torch.from_numpy(mpg.fresh_binned(0, S, K, C))
    got = model_gather("binned", lambda pos: pos, idx, S, C, True, sms,
                       -1.0).long()
    assert torch.equal(got, idx.long())
    byte = got * 4
    assert int(byte.max()) >= 2**32
    assert not torch.equal(byte % 2**32, byte)


@pytest.mark.parametrize("name", ["vmem", "binned"])
def test_one_tile_per_block_at_published_shapes(name):
    """N = 262,144: the grid on 132 SMs holds every tile at once."""
    threads, lpt, per_sm = SHAPES[name]
    tiles = 262144 // (threads * lpt)
    assert tiles <= H100_SMS * per_sm
    assert grid_blocks(name, 262144, H100_SMS) == tiles


@pytest.mark.parametrize("name", ["vmem", "binned"])
def test_source_shapes_fit_the_model(name):
    """The model reads each shape from the source; the source's ring has
    the model's two stages and its groups are whole 16-byte copies."""
    threads, lpt, per_sm = SHAPES[name]
    assert lpt % 4 == 0 and threads % 32 == 0 and per_sm >= 1
    stages = re.search(r"int32_t ring\[(\d+)\]\[TL\]", SOURCE)
    assert stages and int(stages.group(1)) == STAGES


# -- taa1: one warp per row (csrc/pgather.cu, taa1_kernel) -------------------

def taa1_shape():
    """(warps per block, blocks per SM) of taa1, as the source declares them."""
    found = re.search(r"constexpr int TAA1_WARPS = (\d+), "
                      r"TAA1_BLOCKS_PER_SM = (\d+);", SOURCE)
    assert found, "no taa1 shape in csrc/pgather.cu"
    return tuple(map(int, found.groups()))


def taa1_vec(*tensors):
    """The launcher's choice of the 16-byte path (taa1_vec in the source)."""
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def taa1_slots(vec):
    """(writer lane, register component) of each of the 128 slots of a
    warp's shared-memory slice, and the lane that stores each output:
    on the 16-byte path lane t loads, writes and stores elements 4t ..
    4t + 3 (lane q >> 2, component q & 3); on the scalar path elements t,
    t + 32, t + 64, t + 96 (lane q & 31, component q >> 5)."""
    lane = torch.arange(32)[:, None]
    comp = torch.arange(4)[None, :]
    slot = lane * 4 + comp if vec else comp * 32 + lane
    writer = torch.full((128,), -1)
    component = torch.full((128,), -1)
    writer[slot.reshape(-1)] = lane.expand(32, 4).reshape(-1)
    component[slot.reshape(-1)] = comp.expand(32, 4).reshape(-1)
    counts = torch.bincount(slot.reshape(-1), minlength=128)
    assert bool((counts == 1).all()), "a slot written other than once"
    return writer, component


def taa1_model(tab, idx, vec, sms=H100_SMS):
    """taa1_kernel's output: the grid of one wave walks the rows warp by
    warp, each lane's registers hold its 4 row values, the slice gives
    output q the value its writer lane put there, NaN outside the row."""
    warps, per_sm = taa1_shape()
    R = idx.shape[0]
    G = min(-(-R // warps), sms * per_sm)  # tile_blocks(R, warps, per_sm)
    visits = torch.zeros(R, dtype=torch.int64)
    for gw in range(G * warps):  # block gw // warps, warp gw % warps
        visits[gw::G * warps] += 1
    assert bool((visits == 1).all()), "a row walked other than once"
    writer, component = taa1_slots(vec)
    lane = torch.arange(32)[:, None]
    comp = torch.arange(4)[None, :]
    held = (lane * 4 + comp if vec else comp * 32 + lane).reshape(-1)
    regs = tab[:, held].reshape(R, 32, 4)  # lane t's 4 registers
    q = idx.long()
    ok = (q >= 0) & (q < 128)
    qc = q.clamp(0, 127)
    if vec:
        assert torch.equal(writer[qc], qc >> 2) and torch.equal(component[qc], qc & 3)
    rows = torch.arange(R)[:, None].expand_as(qc)
    vals = regs[rows, writer[qc], component[qc]]
    return torch.where(ok, vals, torch.full_like(vals, float("nan")))


def taa1_inputs(R, seed=0, bad=False):
    gen = np.random.default_rng(seed)
    tab = torch.from_numpy(gen.random((R, 128), dtype=np.float32))
    idx = torch.from_numpy(gen.integers(0, 128, (R, 128)).astype(np.int32))
    if bad:
        flat = idx.view(-1)
        flat[::7] = -1
        flat[3::7] = 128
        flat[5::7] = 1 << 30
    return tab, idx


@pytest.mark.parametrize("sms", [H100_SMS, 2])
@pytest.mark.parametrize("vec", [True, False], ids=["vec16", "scalar"])
@pytest.mark.parametrize("R", [1, 3, 2048, 2049])
def test_taa1_model_equals_plain(R, vec, sms):
    """R = 1 and 3 leave most of a block's warps idle, 2,049 rows are no
    multiple of the rows per block, and two SMs make each warp walk
    many rows."""
    tab, idx = taa1_inputs(R, seed=R)
    assert torch.equal(taa1_model(tab, idx, vec, sms), pg.taa1_gather(tab, idx))


@pytest.mark.parametrize("vec", [True, False], ids=["vec16", "scalar"])
def test_taa1_model_fills_out_of_range_indices(vec):
    """Indices below 0 and above 127 read nothing and give NaN."""
    tab, idx = taa1_inputs(2049, seed=5, bad=True)
    bad = (idx < 0) | (idx > 127)
    assert int(bad.sum()) > 0
    got = taa1_model(tab, idx, vec)
    want = pg.taa1_gather(tab, idx.clamp(0, 127))
    assert torch.equal(got.isnan(), bad)
    assert torch.equal(got[~bad], want[~bad])


def test_taa1_unaligned_inputs_take_the_scalar_path():
    tab, idx = taa1_inputs(2049, seed=7)
    out = torch.empty(idx.shape)
    assert taa1_vec(tab, idx, out)
    utab, uidx = at_4_byte_offset(tab), at_4_byte_offset(idx)
    for args in ((utab, idx, out), (tab, uidx, out),
                 (tab, idx, at_4_byte_offset(out))):
        assert not taa1_vec(*args)
    got = taa1_model(utab, uidx, taa1_vec(utab, uidx, out))
    assert torch.equal(got, pg.taa1_gather(tab, idx))


def test_taa1_grid_is_one_wave_at_the_published_shape():
    """R = 2,048: one warp per row, every row's warp resident at once."""
    warps, per_sm = taa1_shape()
    assert 32 * warps * per_sm <= 2048  # threads an SM holds
    assert -(-2048 // warps) <= H100_SMS * per_sm
