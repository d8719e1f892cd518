"""A stable sort of a pool's lanes on the card (csrc/lanesort.cu):
sortingSK's Morton reorder and brickSK's per-round sort by brick.

On the TPU both sorts are an XLA argsort inside a `lax.while_loop`'s one
device program: cudavolumerenderer_tpu/models/streaming.py:113
`_morton_reorder` (the Morton key of each lane, a stable argsort, a take of
every pool field) and models/brick.py:387 (`jnp.argsort(keys)` of brickSK's
round).  Here each is a few launches of one LSD radix sort of 8-bit digits,
each launch gated on the loop's control words (it returns untouched once
the loop has stopped, as the body launches around it do), so the host
reads nothing:

  morton  the keys launch (the Morton code of a live lane, 2^30 for a dead
          one), 4 passes, the gather of every field by the order into a
          scratch pool and its copy back into the pool's own tensors (so the
          prepared body launches' pointers stay valid): 7 launches;
  brick   the keys launch (SENTINEL as n_bricks), ceil(bits(n_bricks) / 8)
          passes, the last writing skeys and order as torch.sort does.

This module holds the library (built through stages at first use), the
plain versions (`plain_morton_reorder_`: morton.ray_sort_keys,
torch.argsort(stable=True), fast._take_lanes and familybody.copy_lanes_;
brickSK's is torch.sort(keys, stable=True)), the wrappers
(`morton_reorder_`, `brick_sort_`: the plain version for CPU tensors, the
kernels for CUDA tensors, or they raise), the prepared launches the loops
reuse (`KERNEL.prepare_morton`, `KERNEL.prepare_brick`, `KERNEL.launch`)
and the bound (`sort_bytes`).
"""

from __future__ import annotations

import ctypes
import dataclasses
from pathlib import Path

import numpy as np
import torch

from . import familybody, morton, stages
from .stages import N_CTRL, lane_field
from .stages import f32 as _f32

_SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "lanesort.cu"

#: the kernel's geometry (csrc/lanesort.cu): threads a block, keys a lane
#: holds in a pass, a pass's digit bits, the most passes
THREADS, ITEMS, RADIX_BITS, MAX_PASSES = 256, 8, 8, 4
TILE = THREADS * ITEMS  # keys a block ranks in a pass
RADIX = 1 << RADIX_BITS
#: the fields a Morton sort permutes, in the kernel's order, and their
#: bytes a lane (a StreamState's, the RNG's two words split)
FIELDS = familybody.LANE_FIELDS
FIELD_BYTES = tuple(familybody.FIELD_BYTES[n] for n in FIELDS)
N_LANE = len(FIELDS)
# Pointer slots (csrc/lanesort.cu S_*).
S_SCRATCH = N_LANE
(S_KA, S_KB, S_IA, S_IB, S_COUNTS, S_CTRL, S_KEYS, S_SKEYS,
 S_ORDER) = range(2 * N_LANE, 2 * N_LANE + 9)
N_S = S_ORDER + 1
MODES = ("morton", "brick")
#: a dead lane's Morton key in the kernel (DEAD_KEY's place: after every
#: 30-bit code)
DEAD = 1 << 30
#: brickSK's key of a lane that cannot track (ops/brickbody.py SENTINEL)
SENTINEL = 0x7FFFFFFF
#: bytes a lane of the sort's bookkeeping: a key (uint32), an index
#: (int32), brickSK's keys and skeys (int32) and its order (int64)
KEY_BYTES, INDEX_BYTES, ORDER_BYTES = 4, 4, 8


def passes_for(top: int) -> int:
    """The radix passes that sort keys of at most `top`."""
    return max(1, -(-int(top).bit_length() // RADIX_BITS))


# -- the plain versions --------------------------------------------------------

def plain_morton_reorder_(box_min, box_max, pool) -> None:
    """sortingSK's sort point (streaming._morton_reorder) on the pool's own
    tensors: the Morton keys (DEAD_KEY for dead lanes), the stable argsort,
    every field taken by it and copied back."""
    from ..models.fast import _take_lanes  # noqa: PLC0415

    keys = morton.ray_sort_keys(pool.o, box_min, box_max, pool.alive)
    familybody.copy_lanes_(
        pool, _take_lanes(pool, torch.argsort(keys, stable=True)))


# -- the kernels ---------------------------------------------------------------

@dataclasses.dataclass
class Prepared:
    """The arguments of one sort (its launches) and the host arrays and
    tensors they point at (kept alive with them)."""

    op: str
    args: tuple
    keep: tuple
    launches: int  # CUDA launches a sort makes


class LaneSortKernel(stages.BodyKernel):
    """The sort's CUDA library, built from csrc/lanesort.cu at first use
    (stages.BodyKernel) and counted: `by_op` counts the sorts of each mode
    made now (a gated one may return untouched), `launches` their CUDA
    launches (`captured` those recorded into a CUDA graph)."""

    def __init__(self):
        super().__init__("lanesort", _SOURCE, (N_LANE, N_S, TILE, N_CTRL),
                         has_drain=False, has_launch=False)
        self._buffers = {}
        self.reset()

    def reset(self) -> None:
        """Every count to 0."""
        self.launches = self.captured = 0
        self.by_op = dict.fromkeys(MODES, 0)

    def library(self):
        if self._built is None:
            built = super().library()
            fn = self._entry(built, "run")
            fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong,
                           ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                           ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
            fn.restype = ctypes.c_int
            sizes = (ctypes.c_int * N_LANE)()
            self._entry(built, "fields")(sizes)
            if tuple(sizes) != FIELD_BYTES:
                raise RuntimeError(f"lanesort: {_SOURCE.name}'s field bytes "
                                   f"{tuple(sizes)} are not {FIELD_BYTES}")
        return self._built

    def buffers(self, dev, width: int, passes: int, morton_pool=None):
        """The sort's device scratch for `width` lanes, made once: two key
        and two index buffers, the passes' histograms and (for a Morton
        sort) a scratch pool of every field."""
        k = (dev, width, passes, morton_pool is not None)
        if k not in self._buffers:
            tiles = -(-width // TILE)

            def e(n, dtype=torch.int32):
                return torch.empty(n, dtype=dtype, device=dev)

            scratch = () if morton_pool is None else tuple(
                torch.empty_like(lane_field(morton_pool, n)) for n in FIELDS)
            self._buffers[k] = (e(width), e(width), e(width), e(width),
                                e(passes * tiles * RADIX), scratch)
        return self._buffers[k]

    def _prepare(self, op: str, dev, width: int, top: int, ptrs: list,
                 ctrl, chain: int, box, keep: tuple, pool=None) -> Prepared:
        if ctrl is not None:
            if (ctrl.device != dev or ctrl.dtype != torch.int64
                    or ctrl.ndim != 1 or ctrl.shape[0] < N_CTRL
                    or not ctrl.is_contiguous()):
                raise ValueError(f"lanesort: ctrl must be contiguous int64 "
                                 f"of at least {N_CTRL} words on {dev}")
        if chain < 1:
            raise ValueError(f"lanesort: a chain of {chain}")
        passes = passes_for(top)
        ka, kb, ia, ib, counts, scratch = self.buffers(dev, width, passes,
                                                       pool)
        for slot, x in zip(range(S_SCRATCH, S_SCRATCH + len(scratch)),
                           scratch):
            ptrs[slot] = x.data_ptr()
        for slot, x in ((S_KA, ka), (S_KB, kb), (S_IA, ia), (S_IB, ib),
                        (S_COUNTS, counts), (S_CTRL, ctrl)):
            ptrs[slot] = 0 if x is None else x.data_ptr()
        addresses = (ctypes.c_void_p * N_S)(*ptrs)
        box = np.ascontiguousarray(box, np.float32)
        args = (MODES.index(op), box.ctypes.data, top, passes,
                ctypes.addressof(addresses), N_S, chain, width)
        return Prepared(op, args, (box, addresses, ctrl, scratch, *keep),
                        1 + passes + (2 if op == "morton" else 0))

    def prepare_morton(self, ctx, pool, ctrl=None, chain: int = 1) -> Prepared:
        """The checked arguments of Morton sorts of the StreamState `pool`
        in place, in the medium box of the FamilyContext `ctx`; gated on
        `ctrl` (chain `chain`, threshold 0) when given."""
        dev = pool.alive.device
        width = pool.alive.shape[0]
        if not hasattr(pool, "tracking"):
            raise ValueError("lanesort: a Morton sort runs on a StreamState")
        ptrs = [0] * N_S
        for f, name in enumerate(FIELDS):
            x = lane_field(pool, name)
            familybody._check(name, x, width, dev)
            ptrs[f] = x.data_ptr()
        med = ctx.scene.medium
        bmin = _f32(med.box_min)
        box = np.concatenate([bmin, _f32(med.box_max) - bmin])
        return self._prepare("morton", dev, width, DEAD, ptrs, ctrl, chain,
                             box, (), pool)

    def prepare_brick(self, bufs, ctrl=None, n_bricks=None) -> Prepared:
        """The checked arguments of brickSK sorts of `bufs.keys` (int32, in
        [0, n_bricks) or SENTINEL) into `bufs.skeys` and `bufs.order`;
        gated on `ctrl` (chain 1) when given.  Without n_bricks the keys
        take 31 bits (4 passes)."""
        dev = bufs.keys.device
        width = bufs.keys.shape[0]
        for name, x, dtype in (("keys", bufs.keys, torch.int32),
                               ("skeys", bufs.skeys, torch.int32),
                               ("order", bufs.order, torch.int64)):
            stages.check_lane("lanesort", name, x, dtype, (width,), dev)
        top = SENTINEL if n_bricks is None else int(n_bricks)
        if not 0 < top <= SENTINEL:
            raise ValueError(f"lanesort: {n_bricks} bricks")
        ptrs = [0] * N_S
        ptrs[S_KEYS] = bufs.keys.data_ptr()
        ptrs[S_SKEYS] = bufs.skeys.data_ptr()
        ptrs[S_ORDER] = bufs.order.data_ptr()
        return self._prepare("brick", dev, width, top, ptrs, ctrl, 1,
                             np.zeros(6, np.float32),
                             (bufs.keys, bufs.skeys, bufs.order))

    def launch(self, prep: Prepared, dev) -> None:
        """One prepared sort on the current stream, counted."""
        fn = self._entry(self.library(), "run")
        with torch.cuda.device(dev):
            self._raise(fn(*prep.args, torch.cuda.current_stream(
                dev).cuda_stream), f"{prep.op} sort")
        if torch.cuda.is_current_stream_capturing():
            self.captured += prep.launches
        else:
            self.launches += prep.launches
            self.by_op[prep.op] += 1


KERNEL = LaneSortKernel()


def _route(dev, ctrl) -> bool:
    """Whether a sort on `dev` goes to the kernels (CUDA) or to the plain
    version (the CPU, ungated: the loops gate on the card only)."""
    if dev.type == "cuda":
        return True
    if dev.type != "cpu":
        raise ValueError(f"lanesort: no kernel for device {dev}")
    if ctrl is not None:
        raise ValueError("lanesort: a gated sort runs on the card")
    return False


def morton_reorder_(ctx, pool, ctrl=None, chain: int = 1) -> None:
    """sortingSK's sort point on the StreamState `pool` in place (its
    tensors stay its own), in the medium box of `ctx` (a FamilyContext):
    the plain version for CPU tensors, the kernels for CUDA tensors, gated
    on the control words `ctrl` (chain `chain`) when given."""
    dev = pool.alive.device
    if _route(dev, ctrl):
        KERNEL.launch(KERNEL.prepare_morton(ctx, pool, ctrl, chain), dev)
    else:
        med = ctx.scene.medium
        plain_morton_reorder_(med.box_min, med.box_max, pool)


def brick_sort_(bufs, ctrl=None, n_bricks=None) -> None:
    """brickSK's sort of a round: bufs.keys stably into bufs.skeys and
    bufs.order, torch.sort(stable=True) for CPU tensors, the kernels for
    CUDA tensors, gated on `ctrl` (chain 1) when given."""
    dev = bufs.keys.device
    if _route(dev, ctrl):
        KERNEL.launch(KERNEL.prepare_brick(bufs, ctrl, n_bricks), dev)
    else:
        torch.sort(bufs.keys, stable=True, out=(bufs.skeys, bufs.order))


# -- the bound -----------------------------------------------------------------

def sort_bytes(n: int, op: str, passes: int = 0) -> int:
    """The least bytes a sort of n lanes moves: a Morton sort reads and
    writes every field of every lane once (FIELD_BYTES, 107 B a lane); a
    brick sort reads its keys (4 B) and writes skeys (4 B) and order (8 B).
    With `passes`, plus the radix passes' own traffic: the keys written
    once by the keys launch, and each pass a key and an index read and
    written."""
    if op == "morton":
        per = 2 * sum(FIELD_BYTES)
    elif op == "brick":
        per = KEY_BYTES + KEY_BYTES + ORDER_BYTES
    else:
        raise ValueError(f"lanesort: no sort {op!r}")
    if passes:
        per += KEY_BYTES + passes * 2 * (KEY_BYTES + INDEX_BYTES)
    return n * per
