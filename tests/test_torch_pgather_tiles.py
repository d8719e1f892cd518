"""The tile kernel of vmem and binned (csrc/pgather.cu, gather_tiles) on the CPU.

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
tests/test_torch_cuda.py holds the kernel itself on the card.
"""

import functools
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from cudavolumerenderer_tpu_torch.benchmarks import micro_pgather as mpg
from cudavolumerenderer_tpu_torch.ops import pgather as pg

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
