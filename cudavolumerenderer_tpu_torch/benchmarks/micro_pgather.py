"""Microbench: how fast can the card read the density table at random
indices?

Port of benchmarks/micro_pgather.py, the JAX script that measured the
gather wall of the fastSK body on the TPU before a tracking kernel was
built around any candidate.  Same variants, flags, printed lines and
JSON keys; the five Pallas variants run the hand-written CUDA kernels of
ops/pgather.py, the others are plain torch ops.

    python -m cudavolumerenderer_tpu_torch.benchmarks.micro_pgather \
        [--platform cuda|cpu] [--table-mb 67] [--n 262144] [--shards 16] \
        [--inner 16] [--reps 4] [--only a,b] [--json-out path]

`--platform cuda` (the default) needs a card and raises without one;
`--platform cpu` runs the plain versions, for checking, not for timing.

Protocol (the JAX script's): each variant runs --inner gathers with a
per-iteration index shift (j = i + k, wrapped) and a data dependency
through the accumulator; fresh random indices per rep; a host readback
of the first 8 outputs (the printed `chk`) fences each rep; rep 0 is
discarded.  On the card one timed call is one replay of a CUDA graph
captured over the --inner loop, the counterpart of the JAX script's one
jit dispatch: launched one by one, each wrapper's ~30 us of host time
would be what got measured.  Fresh indices are copied into the graph's
static inputs before the clock starts.  Nothing is caught: a build,
launch or capture failure raises.  After timing, each pallas_* variant
is held against its plain version on the same inputs, bit for bit.

Variants (--only selects; each runs alone under its own name):

  xla_big        take from the full table: the wall (baseline)
  xla_sorted     the same with pre-sorted indices (locality probe)
  xla_slice      per-shard slice + take on perfectly binned indices
  xla_batched    one batched gather, (S, C) table x (S, K) indices
  xla_small      take from a table that is small (1 MB / 4 MB)
  xla_wide       (rows, 2) row gathers at 1 / 8 / 16 MB
  xla_packed     4-bit packed table: a (V/16, 2) int32 row gather + nibble
  xla_packed8    8-bit packed table: (V/8, 2) int32 rows + byte
  xla_packed8f   8-bit flat table: (V/4,) int32 + byte
  bin_argsort    stable argsort by shard id + permute (binning lever 1)
  bin_scatter    one-hot cumsum rank + permutation scatter (lever 2)
  perm_gather    one (N,) -> (N,) permutation gather
  pallas_taa1    CUDA taa1: per-row 128-entry tables along lanes
  pallas_taa0    CUDA taa0: column gather over all rows
  pallas_vmem    CUDA vmem: flat gather from a table of at most 8 MB
  pallas_stream  CUDA stream: one read per lane, 0 outside the table
  pallas_binned  CUDA binned: perfectly binned indices, shard by shard
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ..cli import device_of
from ..ops import pgather as pg

VARIANTS = (
    "xla_big", "xla_sorted", "xla_slice", "xla_batched", "xla_small",
    "xla_wide", "xla_packed", "xla_packed8", "xla_packed8f", "bin_argsort",
    "bin_scatter", "perm_gather", "pallas_taa1", "pallas_taa0",
    "pallas_vmem", "pallas_stream", "pallas_binned",
)
VMEM_ENTRIES = (8 << 20) // 4  # pallas_vmem's table: at most 8 MB


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m cudavolumerenderer_tpu_torch.benchmarks.micro_pgather")
    ap.add_argument("--platform", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--only", default=None,
                    help="comma-separated variant names")
    ap.add_argument("--table-mb", type=float, default=67.0,
                    help="table size in MB (67=medical, 4300=1024^3)")
    ap.add_argument("--n", type=int, default=262144, help="gather rows")
    ap.add_argument("--shards", type=int, default=16)
    ap.add_argument("--inner", type=int, default=16,
                    help="gathers per timed call (one CUDA graph replay)")
    ap.add_argument("--reps", type=int, default=4)
    ap.add_argument("--json-out", default=None)
    return ap.parse_args(argv)


# -- inputs, made with numpy as the JAX script makes them ------------------

def table_rows(table_mb: float, shards: int) -> int:
    """V: the table's entries, shard- and lane-aligned."""
    V = int(table_mb * (1 << 20) // 4)
    return V - V % (128 * shards)


def make_table(V: int) -> np.ndarray:
    return np.random.default_rng(0).random(V, dtype=np.float32)


def fresh_idx(rep: int, n: int, lim: int) -> np.ndarray:
    return np.random.default_rng(rep + 1).integers(0, lim, n).astype(np.int32)


def fresh_binned(rep: int, S: int, K: int, C: int) -> np.ndarray:
    """(S, K) indices, row s uniform within shard s (perfect bins)."""
    loc = np.random.default_rng(rep + 1).integers(0, C, (S, K)).astype(np.int32)
    return loc + (np.arange(S, dtype=np.int32) * C)[:, None]


def packed_table(seed: int, shape) -> np.ndarray:
    """Random int32 words in [0, 2^31): the packed tables (seeds 5, 6, 7)."""
    return np.random.default_rng(seed).integers(0, 1 << 31, shape).astype(np.int32)


def kernel_args(name: str, table: torch.Tensor, N: int, S: int, rep: int = 0):
    """The arguments the benchmark gives gather kernel `name`'s wrapper
    (ops/pgather.py) on rep `rep`'s indices at the loop's first
    iteration, on table's device."""
    V = table.shape[0]
    R = N // 128

    def idx(lim):
        return torch.from_numpy(fresh_idx(rep, N, lim)).to(table.device)

    if name == "taa1":
        return table[:N].view(R, 128), (idx(N) % 128).view(R, 128)
    if name == "taa0":
        return table[:N].view(R, 128), (idx(N) % R).view(R, 128)
    if name == "vmem":
        Vv = min(V, VMEM_ENTRIES)
        return table[:Vv], idx(Vv).view(R, 128)
    if name == "stream":
        return table, idx(V).view(R, 128), S
    if name == "binned":
        b = fresh_binned(rep, S, N // S, V // S)
        return table, torch.from_numpy(b).to(table.device).view(S, N // S // 128, 128)
    raise ValueError(f"no gather kernel {name!r}")


def bin_positions(i: torch.Tensor, shift: int, S: int) -> torch.Tensor:
    """bin_scatter's target of each index i in shard order (shard id
    i >> shift): JAX's base[sid] + rank within the shard, int32.  That is
    the lane's count in a row-major scan of the (S, N) one-hot, taken here
    as one flat scan: torch scans the leading dimension of an (N, S)
    tensor with one thread per column (262,144 serial steps on the card)
    and the rows of an (S, N) one with one block per row.  The JAX
    script's shift is floor(log2 C), so where C is no power of two some
    shard ids equal S; jnp's takes fill those with INT32_MIN in both
    terms, whose int32 sum wraps to position 0."""
    sid = i >> shift
    shards = torch.arange(S, dtype=torch.int32, device=i.device)
    oh = (shards[:, None] == sid[None, :]).to(torch.int32)
    rank = torch.cumsum(oh.view(-1), 0, dtype=torch.int32).view(S, -1)
    sidc = sid.clamp(max=S - 1).long()
    return torch.where(sid < S, torch.gather(rank, 0, sidc[None, :])[0] - 1, 0)


# -- timing ----------------------------------------------------------------

class EagerRun:
    """fn(*inputs), called as it is (CPU)."""

    def __init__(self, fn, inputs):
        self.fn = fn

    def load(self, inputs):
        self.inputs = inputs

    def run(self):
        return self.fn(*self.inputs)


class GraphRun:
    """fn(*inputs) as one replay of a CUDA graph captured over it on
    `inputs`, which become the graph's static inputs.  Replays add the
    kernel launches they run to the gather kernels' counts."""

    def __init__(self, fn, inputs):
        self.static = inputs
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):  # lazy set-up stays out of the capture
            fn(*inputs)
        torch.cuda.current_stream().wait_stream(side)
        before = {k: kern.captured for k, kern in pg.KERNELS.items()}
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.out = fn(*inputs)
        self.per_replay = {k: kern.captured - before[k]
                           for k, kern in pg.KERNELS.items()}

    def load(self, inputs):
        for static, x in zip(self.static, inputs):
            if x is not static:
                static.copy_(x)
        torch.cuda.synchronize()

    def run(self):
        self.graph.replay()
        for k, n in self.per_replay.items():
            pg.KERNELS[k].launches += n
        return self.out


# -- the benchmark ---------------------------------------------------------

def main(argv=None) -> dict:
    """Run the selected variants; returns the JSON object it writes."""
    args = parse_args(argv)
    dev = device_of(args.platform)
    V = table_rows(args.table_mb, args.shards)
    N = args.n
    S = args.shards
    C = V // S  # entries per shard
    K = N // S  # rows per shard when perfectly binned
    INNER = args.inner
    where = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
             else "host CPU, plain versions")
    print(f"table {V} rows ({V*4/2**20:.0f} MB) N={N} S={S} "
          f"shard {C*4/2**20:.1f} MB inner={INNER} "
          f"platform={args.platform} ({where})", flush=True)

    table = torch.from_numpy(make_table(V)).to(dev)

    def on_dev(a):
        return torch.from_numpy(a).to(dev)

    def idx(rep, n=N, lim=V):
        return on_dev(fresh_idx(rep, n, lim))

    def binned(rep):
        return on_dev(fresh_binned(rep, S, K, C))

    def take(t, j):  # 1-D t at int32 j, no int64 copy of j
        return torch.index_select(t, 0, j.reshape(-1)).reshape(j.shape)

    results = {}
    timer = GraphRun if dev.type == "cuda" else EagerRun

    def looped(core, lim, wrap_shard=False):
        """Run core(t, j) INNER times with j = i+k wrapped into [0,lim)
        (or within each shard when wrap_shard), accumulating results so
        no iteration can be dropped or reordered."""
        def f(t, i):
            if wrap_shard:
                base = (i // C) * C
            acc = torch.zeros(i.shape, dtype=torch.float32, device=i.device)
            for k in range(INNER):
                j = i + k
                if wrap_shard:
                    j = torch.where(j >= base + C, j - C, j)
                else:
                    j = torch.where(j >= lim, j - lim, j)
                acc = acc + core(t, j)
            return acc
        return f

    def bench(name, make_inputs, fn, rows_per_call=None):
        rows = (rows_per_call or N) * INNER
        run = timer(fn, make_inputs(0))
        times = []
        for rep in range(args.reps):
            run.load(make_inputs(rep))
            t0 = time.perf_counter()
            out = run.run()
            s = float(out.reshape(-1)[:8].sum())  # host fence
            dt = time.perf_counter() - t0
            times.append(dt)
            print(f"  {name} rep{rep}: {dt*1e3:8.2f} ms "
                  f"({rows/dt/1e6:7.1f} M rows/s)  chk {s:.2f}",
                  flush=True)
        best = min(times[1:]) if len(times) > 1 else times[0]
        rate = rows / best / 1e6
        print(f"{name}: best {best*1e3:.2f} ms = {rate:.1f} M rows/s",
              flush=True)
        results[name] = {"ms_per_gather": best * 1e3 / INNER,
                         "mrows_s": rate}

    def exact(kernel):
        """The kernel's wrapper against its plain version on rep 0's
        inputs, un-looped."""
        run, plain = pg.WRAPPERS[kernel]
        inputs = kernel_args(kernel, table, N, S)
        ok = torch.equal(run(*inputs), plain(*inputs))
        print(f"  pallas_{kernel} exact: {ok}", flush=True)
        if not ok:
            raise RuntimeError(f"{kernel}: the kernel disagrees with its plain version")

    only = set(args.only.split(",")) if args.only else None

    def want(name):
        return only is None or name in only

    # -- plain torch baselines ----------------------------------------------
    if want("xla_big"):
        bench("xla_big", lambda r: (table, idx(r)), looped(take, V))
    if want("xla_sorted"):
        bench("xla_sorted", lambda r: (table, torch.sort(idx(r)).values),
              looped(take, V))
    if want("xla_slice"):
        def slice_take(t, jb):  # jb (S, K) globally indexed, binned
            return torch.stack([take(t[s * C:(s + 1) * C], jb[s] - s * C)
                                for s in range(S)])
        bench("xla_slice", lambda r: (table, binned(r)),
              looped(slice_take, V, wrap_shard=True))
    if want("xla_batched"):
        t3 = table.view(S, C)
        bench("xla_batched", lambda r: (t3, binned(r)),
              looped(lambda t, jb: torch.gather(t, 1, (jb % C).long()), V,
                     wrap_shard=True))
    if want("xla_small"):
        for mb, tag in ((1.0, "1mb"), (4.0, "4mb")):
            Vs = int(mb * (1 << 20) // 4)
            tabs = table[:Vs]
            if Vs > V:  # jnp.take's fill: an index past a short table gives NaN
                tabs = torch.cat([tabs, tabs.new_full((Vs - V,), float("nan"))])
            bench(f"xla_small_{tag}", lambda r, Vs=Vs: (tabs, idx(r, N, Vs)),
                  looped(take, Vs))
    if want("xla_wide"):
        # (rows, 2) row gathers: the probe-table class, by table size
        for rows, tag in ((131072, "1mb"), (1 << 20, "8mb"),
                          (1 << 21, "16mb")):
            if rows * 2 > V:
                continue
            t2 = table[:rows * 2].view(rows, 2)
            bench(f"xla_wide_{tag}",
                  lambda r, rows=rows: (t2, idx(r, N, rows)),
                  looped(lambda t, j: torch.index_select(t, 0, j).sum(-1),
                         rows))
    if want("xla_packed"):
        # 4-bit packed density table: V voxels in (V/16, 2) int32 rows
        tp = on_dev(packed_table(5, (max(V // 16, 1024), 2)))
        def packed_take(t, j):
            row = torch.index_select(t, 0, j >> 4)  # (N, 2) int32
            word = torch.where(((j >> 3) & 1) == 0, row[:, 0], row[:, 1])
            nib = (word >> ((j & 7) << 2)) & 0xF
            return nib.to(torch.float32) * (1.0 / 15.0)
        bench("xla_packed", lambda r: (tp, idx(r)), looped(packed_take, V))
        del tp
    if want("xla_packed8"):
        # 8-bit variant: (V/8, 2) int32 rows (8 bytes per row)
        tp8 = on_dev(packed_table(6, (max(V // 8, 1024), 2)))
        def packed8_take(t, j):
            row = torch.index_select(t, 0, j >> 3)
            word = torch.where(((j >> 2) & 1) == 0, row[:, 0], row[:, 1])
            byte = (word >> ((j & 3) << 3)) & 0xFF
            return byte.to(torch.float32) * (1.0 / 255.0)
        bench("xla_packed8", lambda r: (tp8, idx(r)), looped(packed8_take, V))
        del tp8
    if want("xla_packed8f"):
        # 8-bit flat variant: (V/4,) int32, one narrow gather + byte select
        tp8f = on_dev(packed_table(7, max(V // 4, 1024)))
        def packed8f_take(t, j):
            word = take(t, j >> 2)
            byte = (word >> ((j & 3) << 3)) & 0xFF
            return byte.to(torch.float32) * (1.0 / 255.0)
        bench("xla_packed8f", lambda r: (tp8f, idx(r)),
              looped(packed8f_take, V))
        del tp8f

    # -- binning / permutation costs ----------------------------------------
    shift = int(np.log2(C))
    if want("bin_argsort"):
        bench("bin_argsort", lambda r: (table, idx(r)),
              looped(lambda _, j: take(j, torch.argsort(j >> shift, stable=True))
                     .to(torch.float32), V))
    if want("bin_scatter"):
        def csort(_, i):
            pos = bin_positions(i, shift, S)
            # every position lies in [0, N), so .at[].set's mode="drop"
            # drops nothing
            return torch.zeros(N, dtype=torch.float32, device=i.device).scatter_(
                0, pos.long(), i.to(torch.float32))
        bench("bin_scatter", lambda r: (table, idx(r)), looped(csort, V))
    if want("perm_gather"):
        bench("perm_gather",
              lambda r: (idx(r, N, N).to(torch.float32), idx(r + 100, N, N)),
              looped(take, N))

    # -- the CUDA kernels (the Pallas variants) ------------------------------
    R = N // 128
    if want("pallas_taa1"):
        tab1 = table[:N].view(R, 128)
        bench("pallas_taa1", lambda r: (tab1, idx(r, N, N)),
              looped(lambda t, j: pg.run_taa1(t, (j % 128).view(R, 128))
                     .view(N), N))
        exact("taa1")
    if want("pallas_taa0"):
        tab0 = table[:N].view(R, 128)
        bench("pallas_taa0", lambda r: (tab0, idx(r, N, N)),
              looped(lambda t, j: pg.run_taa0(t, (j % R).view(R, 128))
                     .view(N), N))
        exact("taa0")
    if want("pallas_vmem"):
        # the table held whole: at most 8 MB, as on the TPU
        Vv = min(V, VMEM_ENTRIES)
        tabv = table[:Vv]
        bench("pallas_vmem", lambda r: (tabv, idx(r, N, Vv)),
              looped(lambda t, j: pg.run_vmem(t, j.view(R, 128)).view(N), Vv))
        exact("vmem")
    if want("pallas_stream"):
        bench("pallas_stream", lambda r: (table, idx(r)),
              looped(lambda t, j: pg.run_stream(t, j.view(R, 128), S).view(N),
                     V))
        exact("stream")
    if want("pallas_binned"):
        bench("pallas_binned", lambda r: (table, binned(r)),
              looped(lambda t, j: pg.run_binned(t, j.view(S, K // 128, 128))
                     .view(S, K), V, wrap_shard=True))
        exact("binned")

    out = {"V": V, "N": N, "S": S, "inner": INNER,
           "platform": args.platform, "results": results}
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(out, f, indent=1)
        print("wrote", args.json_out)
    return out


if __name__ == "__main__":
    main()
