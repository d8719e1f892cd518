"""The host side that the per-lane body kernels share (csrc/fastbody.cu,
csrc/replaybody.cu, csrc/familybody.cu, csrc/brickbody.cu and
csrc/fastqbody.cu; their device side of it in csrc/common.cuh).

A body kernel runs one evaluation of every lane of a pool per launch.  A
cascade stage of the body is a loop of such evaluations in chains of
`k_chain`, whose count (pending or alive lanes) the host reads at each
chain's end; the loop exits once the count is at or under the stage's
threshold.  On the card a stage runs in one of two ways:

* gated chains (a threshold above 0, or a loop whose count is read only at a
  chain's end): each launch reads the stage's control
  words and returns untouched where the loop would have stopped (at a
  chain's start, with the count at or under the threshold); the host
  enqueues whole chains `GATED_BATCH` evaluations at a time and reads the
  words once per batch (`BodyKernel.gated`);
* the drain (the last stage, threshold 0, so no lane waits for another):
  each lane runs to its end in registers, `DRAIN_CAP` evaluations per
  launch at most; the host reads the words once per launch and launches
  again while lanes are left (`BodyKernel.drain`);
* a queue-fed loop (a gated stage whose count is 0 at its end, then a drain
  of the rest): the drain enqueued behind every batch of the gated chains,
  opening on the card once the stage has stopped (`BodyKernel.queued`).

`loop_chains` is the plain version of a stage, and both ways equal it.
This module also holds the library loading and layout check, the checks of
the per-lane tensors a launch is given, and the per-lane state traffic
that the bounds count (`lane_traffic`, `state_bytes`, `Traffic`).
"""

from __future__ import annotations

import ctypes
import time
from pathlib import Path
from typing import Callable

import numpy as np
import torch

# A stage's control words (csrc/common.cuh C_*, int64): the evaluations run,
# the last count, the drain's longest finished lane, its accumulators (lanes
# left at the cap, the most evaluations a lane ran in the launch, the block
# ticket), the lanes left after a drain launch and the stage's evaluations
# once no lane is left.
(C_EVAL, C_COUNT, C_LMAX, C_LEFT_ACC, C_JMAX, C_TICKET, C_LEFT, C_TOTAL,
 N_CTRL) = range(9)

#: evaluations enqueued per host read in a gated stage (rounded up to a
#: whole number of chains)
GATED_BATCH = 32
#: the drain's evaluations per lane and launch; a lane at the cap is
#: stored, and the host launches again
DRAIN_CAP = 8192

# The leading arguments of every C entry point: fparams, n_fp, iparams,
# n_ip, ptrs, n_s, width.
_ARGTYPES = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
             ctypes.c_void_p, ctypes.c_int, ctypes.c_int]


def f32(x) -> np.ndarray:
    """A tensor's (or number's) float32 values on the host."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", torch.float32).numpy().reshape(-1)
    return np.asarray(x, np.float32).reshape(-1)


def lane_field(s, name: str) -> torch.Tensor:
    """A pool's per-lane field by its kernel name (the RNG's two words
    split into rng_state and rng_inc)."""
    if name == "rng_state":
        return s.rng.state
    if name == "rng_inc":
        return s.rng.inc
    return getattr(s, name)


def own(s):
    """The pool with every tensor its own contiguous copy, for the kernels'
    in-place updates (an eager pool may share or broadcast tensors)."""
    def copy(v):
        if isinstance(v, torch.Tensor):
            return v.contiguous().clone()
        return type(v)(*(copy(x) for x in v))

    return type(s)(*(copy(v) for v in s))


def check_lane(kernel: str, name: str, x: torch.Tensor, dtype, shape,
               dev) -> None:
    """Raise unless the per-lane tensor `x` is contiguous `dtype` of
    `shape` on `dev`."""
    if (x.device != dev or x.dtype != dtype or tuple(x.shape) != shape
            or not x.is_contiguous()):
        raise ValueError(
            f"{kernel}: {name} must be contiguous {dtype} {shape} on {dev}, "
            f"got {x.dtype} {tuple(x.shape)} on {x.device}")


def overlaps(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Whether two tensors share memory without being the same buffer
    (in place is the same buffer; anything else must not overlap, as a
    lane's thread reads all its fields before it writes any)."""
    a0, b0 = a.data_ptr(), b.data_ptr()
    if a0 == b0:
        return False
    a1 = a0 + a.numel() * a.element_size()
    b1 = b0 + b.numel() * b.element_size()
    return a0 < b1 and b0 < a1


def changed(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Per lane, whether any element differs bit for bit."""
    if x.dtype == torch.float32:
        x, y = x.view(torch.int32), y.view(torch.int32)
    ne = x != y
    return ne.any(dim=-1) if ne.ndim == 2 else ne


def lane_traffic(before, after, reads: dict, names) -> dict:
    """One evaluation's per-lane state traffic: {field: (the lanes that read
    it, the lanes that write it)} for the fields `names` of the pools.
    `reads` maps fields to the lanes whose evaluation reads them before
    writing them (the eager body's masks); a lane writes a field whose value
    changed bit for bit.  The RNG's state, unless `reads` names it, is read
    and written where a draw advanced it, its increment read there."""
    drew = changed(before.rng.state, after.rng.state)
    out = {}
    for name in names:
        w = changed(lane_field(before, name), lane_field(after, name))
        if name in reads:
            out[name] = (reads[name], w)
        elif name == "rng_inc":
            out[name] = (drew, w)
        elif name == "rng_state":
            out[name] = (drew, drew)
        else:
            raise ValueError(f"lane_traffic: no read mask for {name}")
    return out


def merge_traffic(read: dict, written: dict, traffic: dict) -> None:
    """Add one evaluation's lane_traffic to the running masks of a run of
    evaluations: a lane reads a field once, unless an earlier evaluation
    wrote it, and writes it once."""
    for name, (r, w) in traffic.items():
        if name in read:
            read[name] = read[name] | (r & ~written[name])
            written[name] = written[name] | w
        else:
            read[name], written[name] = r, w


def traffic_bytes(read: dict, written: dict, field_bytes: dict) -> int:
    """The bytes of the lanes' reads and writes, at each field's size."""
    return sum(field_bytes[k] * int(torch.count_nonzero(read[k])
                                    + torch.count_nonzero(written[k]))
               for k in read)


def state_bytes(taps, field_bytes: dict) -> int:
    """The per-lane state bytes of the evaluations whose ("state",
    lane_traffic) entries are in `taps`, in order (merge_traffic)."""
    read, written = {}, {}
    for kind, x in taps:
        if kind == "state":
            merge_traffic(read, written, x)
    return traffic_bytes(read, written, field_bytes)


class Traffic:
    """The bytes of evaluations given in order, added one at a time (a
    drain's taps need not be kept): the per-lane fields each lane reads
    before an earlier evaluation wrote them and the fields it writes (the
    ("state", lane_traffic) taps, at `field_bytes`), and each other kind of
    tap's distinct items at `item_bytes[kind]` bytes."""

    def __init__(self, field_bytes: dict, item_bytes: dict):
        self.field_bytes, self.item_bytes = field_bytes, item_bytes
        self.read, self.written, self.seen = {}, {}, {}

    def add(self, taps) -> "Traffic":
        for kind, x in taps:
            if kind != "state":
                prev = self.seen.get(kind)
                x = x.reshape(-1)
                self.seen[kind] = torch.unique(
                    x if prev is None else torch.cat([prev, x]))
                continue
            merge_traffic(self.read, self.written, x)
        return self

    def total(self) -> int:
        n = traffic_bytes(self.read, self.written, self.field_bytes)
        return n + sum(self.item_bytes[k] * int(x.numel())
                       for k, x in self.seen.items())


def loop_chains(kernel: "BodyKernel", s, count_of: Callable,
                body: Callable, thresh: int, k_chain: int):
    """The plain version of a stage: chains of k_chain `body` evaluations
    (body(s) -> (s, its count as a 0-d tensor or None)) while the count
    exceeds `thresh`, read at each chain's end: the body's, or count_of(s)
    where it gave none.  Each read counts in kernel.reads.  Returns the
    pool and its evaluations."""
    count, n = None, 0
    while True:
        c = count_of(s) if count is None else int(count)
        kernel.reads += 1
        if c <= thresh:
            return s, n
        for _ in range(k_chain):
            s, count = body(s)
        n += k_chain


class BodyKernel:
    """A body kernel library: built from `source` at first use, its C entry
    points `<name>_launch` (where `has_launch`), `<name>_drain` (where
    `has_drain`) and `<name>_layout` loaded with ctypes, and its launches
    counted.  `launches` counts one-evaluation
    launches made now (a gated one may return untouched); a launch recorded
    into a CUDA graph being captured counts in `captured` instead.
    `drain_launches` counts drain launches, `reads` the host's reads of a
    stage's control words or count (loop_chains' too), `enqueue_s` the
    host's seconds in gated stages' enqueue loops, and `last_drain` holds
    the last drain's longest lane L, its evaluations E and its launches."""

    def __init__(self, name: str, source: Path, layout: tuple,
                 drain_argtypes: tuple = (), has_drain: bool = True,
                 has_launch: bool = True):
        self.name = name
        self.source = source
        self.layout = tuple(layout)  # (N_FP, N_IP, N_S, N_CTRL)
        self.drain_argtypes = list(drain_argtypes)
        self.has_drain = has_drain  # whether the library has <name>_drain
        self.has_launch = has_launch  # whether it has <name>_launch
        self.launches = 0  # CUDA launches; the plain version is not counted
        self.captured = 0
        self.drain_launches = 0
        self.reads = 0
        self.enqueue_s = 0.0
        self.last_drain = None
        self._built = None
        self._zeros = {}

    def library(self):
        """Build (or reuse) and load the kernel library; returns the
        utils.cuda_build.BuiltLibrary."""
        if self._built is None:
            built = self._build()
            if self.has_launch:
                launch = self._entry(built, "launch")
                launch.argtypes = _ARGTYPES + [ctypes.c_void_p]
                launch.restype = ctypes.c_int
            if self.has_drain:
                drain = self._entry(built, "drain")
                drain.argtypes = _ARGTYPES + self.drain_argtypes + [
                    ctypes.c_void_p]
                drain.restype = ctypes.c_int
            sizes = (ctypes.c_int * 4)()
            self._entry(built, "layout")(sizes)
            if tuple(sizes) != self.layout:
                raise RuntimeError(
                    f"{self.name}: {self.source.name}'s layout {tuple(sizes)} "
                    f"is not the wrapper's {self.layout}")
            self._built = built
        return self._built

    def _build(self):
        """Build (or reuse) the library of `source`."""
        from ..utils import cuda_build  # noqa: PLC0415

        return cuda_build.build_library(self.source)

    def _entry(self, built, what: str):
        return getattr(built.lib, f"{self.name}_{what}")

    def zeros(self, key: str, n: int, dtype, dev) -> torch.Tensor:
        """A zeroed device buffer the kernels reuse and leave zero (the
        scratch of a launch's reductions, a drain's per-evaluation sums)."""
        k = (key, dev, n, dtype)
        if k not in self._zeros:
            self._zeros[k] = torch.zeros(n, dtype=dtype, device=dev)
        return self._zeros[k]

    @staticmethod
    def args(fparams: np.ndarray, iparams: np.ndarray, addresses,
             width: int) -> tuple:
        """The leading arguments of a C entry point."""
        return (fparams.ctypes.data, len(fparams), iparams.ctypes.data,
                len(iparams), ctypes.addressof(addresses), len(addresses),
                width)

    def _raise(self, err: int, what: str) -> None:
        if err != 0:
            raise RuntimeError(f"{self.name} {what} failed: CUDA error {err}")

    def launch_one(self, args: tuple, dev) -> None:
        """One evaluation launch on the current stream, counted."""
        fn = self._entry(self.library(), "launch")
        with torch.cuda.device(dev):
            self._raise(fn(*args, torch.cuda.current_stream(dev).cuda_stream),
                        "launch")
        if torch.cuda.is_current_stream_capturing():
            self.captured += 1
        else:
            self.launches += 1

    def read(self, words: torch.Tensor) -> list:
        """A host read of control words (or a count), counted."""
        self.reads += 1
        return words.tolist()

    def gated(self, args, ctrl: torch.Tensor, thresh: int, k_chain: int,
              dev, batch: int = GATED_BATCH) -> int:
        """Gated chains of a stage whose loop exits at a chain boundary once
        the count is at most `thresh`: `args` launch one gated evaluation
        whose control words are `ctrl` (C_COUNT holding the stage's count
        at its start), or are a function that enqueues one whole chain of
        gated launches (and counts them).  The host enqueues whole chains
        `batch` evaluations at a time and reads the words once per batch
        (and once at the start).  Returns the stage's evaluations."""
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(f"{self.name}: a gated stage reads the card; "
                               "it cannot be captured")
        if callable(args):
            enqueue = args
        else:
            fn = self._entry(self.library(), "launch")
            full = args + (torch.cuda.current_stream(dev).cuda_stream,)

            def enqueue():
                for _ in range(k_chain):
                    self._raise(fn(*full), "launch")
                    self.launches += 1
        n = -(-batch // k_chain)
        with torch.cuda.device(dev):
            while True:
                e, count = self.read(ctrl[:C_COUNT + 1])
                if e % k_chain == 0 and count <= thresh:
                    return e
                t0 = time.perf_counter()
                for _ in range(n):
                    enqueue()
                self.enqueue_s += time.perf_counter() - t0

    def drain(self, args: tuple, extra: tuple, ctrl: torch.Tensor,
              dev, once: bool = False) -> list:
        """The drain of a last stage: `args` (and the entry's `extra`
        arguments) launch it on control words `ctrl` that were zero at the
        stage's start (but for what the kernel reads there); the host reads
        them once per launch and launches again while lanes are left (with
        `once`, not: each lane then ran at most the cap's evaluations).
        Returns the last launch's control words."""
        fn = self._entry(self.library(), "drain")
        launches = 0
        while True:
            with torch.cuda.device(dev):
                self._raise(fn(*args, *extra, torch.cuda.current_stream(
                    dev).cuda_stream), "drain")
            self.drain_launches += 1
            launches += 1
            words = self.read(ctrl)
            if words[C_LEFT] == 0 or once:
                break
        self.last_drain = {"L": words[C_LMAX], "E": words[C_TOTAL],
                           "launches": launches, "left": words[C_LEFT]}
        return words

    def queued(self, enqueue, args: tuple, ctrl: torch.Tensor, k_chain: int,
               dev, batch: int = GATED_BATCH) -> list:
        """A gated stage whose loop exits at a chain boundary once its count
        is 0, then the drain of the rest: `enqueue` enqueues one whole chain
        of gated launches on the control words `ctrl` (as gated's; None
        where the words start where the stage has stopped: a pool kept
        there), `args` launch the drain on the same words.  The drain is
        enqueued behind every batch of chains and opens on the card once
        the stage has stopped (from the card's words, so the host reads
        them no more often than gated does) and returns untouched before;
        the host launches it again while lanes are left at its cap.
        Returns the last words read; last_drain as drain's."""
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(f"{self.name}: a queue-fed loop reads the "
                               "card; it cannot be captured")
        fn = self._entry(self.library(), "drain")
        n = -(-batch // k_chain)
        launches = 0
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            words = None if enqueue is None else self.read(ctrl)
            while True:
                # the stage has stopped, or a drain left lanes
                stopped = words is None or words[C_LEFT] > 0 or (
                    words[C_EVAL] % k_chain == 0 and words[C_COUNT] <= 0)
                if not stopped:
                    t0 = time.perf_counter()
                    for _ in range(n):
                        enqueue()
                    self.enqueue_s += time.perf_counter() - t0
                self._raise(fn(*args, stream), "drain")
                self.drain_launches += 1
                launches += 1
                words = self.read(ctrl)
                # the drain ended: behind the batch, or in a launch that ran
                if words[C_TOTAL] > 0 or (stopped and words[C_LEFT] == 0):
                    break
        self.last_drain = {"L": words[C_LMAX], "E": words[C_TOTAL],
                           "launches": launches, "left": words[C_LEFT]}
        return words
