"""fastSK's tail stage as one CUDA drain (csrc/tailpk.cu's drain_kernel).

JAX's `_run_tailpk_stage` (cudavolumerenderer_tpu/models/fast.py:1341)
runs its service round (`body`, :1421) under a `lax.while_loop` (:1604),
so XLA compiled the whole stage around the Pallas tail kernel into one
device program.  The port's eager loop (models/fast.py `plain_stage` over
`plain_round`, the plain version) runs a round as a few hundred torch ops,
one tail_kernel launch and a host read of the pending count: ~300 rounds
per fastSK image.  On the card the stage is one launch: a warp holds one
lane of the pool and runs its rounds to the end (a lane's round reads only
its own fields, and a lane that is no longer pending is a fixed point of
the round), `stages.DRAIN_CAP` rounds per launch at most; the last block
folds the per-round counts into n_rays, n_rows and n_busy in the loop's
order.  `stages.BodyKernel.drain` launches and reads the control words
once per launch.

This module holds the gate (`route`), the parameter and pointer layout
(checked against the C layout at load), the parameter vectors
(`make_params`: fastbody's camera, path-id layout, GGX and Le, with the
tail kernel's `tail_params`), the wrapper `run_stage` (the plain stage for
CPU tensors, the drain for CUDA tensors, or it raises) and the bound
(`drain_bytes`).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from . import fastbody as fb
from . import stages, tailpk as tpk
from .stages import DRAIN_CAP, N_CTRL, lane_field
from .stages import f32 as _f32

# Float parameters (csrc/tailpk.cu DF_*): the tail kernel's vector
# (tailpk.P_*), then the service's.
DF_TILEX = tpk.N_PARAMS
DF_TILEY, DF_INV_TW, DF_INV_RESX, DF_INV_RESY = range(DF_TILEX + 1,
                                                      DF_TILEX + 5)
DF_CAM = DF_INV_RESY + 1  # the camera's (3, 4) inv_view, row-major
DF_R2VX = DF_CAM + 12
DF_R2VY = DF_R2VX + 1
DF_BMAX = DF_R2VY + 1
DF_LE = DF_BMAX + 3
DF_ROUGH = DF_LE + 3
DF_ETA = DF_ROUGH + 2
DF_INV_ETA = DF_ETA + 1
DF_EPSW = DF_INV_ETA + 1
N_DF = DF_EPSW + 1

# Integer parameters (csrc/tailpk.cu DI_*).
(DI_SPP, DI_M, DI_NPIX, DI_TW, DI_BASE, DI_SEEDH, DI_BSDF, DI_MITSUBA,
 DI_RR, DI_MAXPATH, DI_NBX, DI_NBY, DI_NBZ, DI_STEPS, DI_CAP,
 N_DI) = range(16)

# Pointer slots (csrc/tailpk.cu S_*): the FastState fields a round updates
# (the RNG's two words split), read and written in place, then the rest.
LANE_FIELDS = ("o", "d", "throughput", "accum", "normal", "t", "max_t",
               "samples_done", "bounce", "alive", "tracking", "rng_state",
               "rng_inc")
N_LANE = len(LANE_FIELDS)
S_EXIT = N_LANE
(S_PIX, S_SLOT, S_COUNTS, S_TAB, S_MAJOR, S_JUMP, S_CTRL,
 S_EVALS) = range(S_EXIT + 1, S_EXIT + 9)
N_S = S_EVALS + 1
_VEC3 = LANE_FIELDS[:5]
_DTYPES = dict(zip(LANE_FIELDS, (torch.float32,) * 7 + (torch.int64,) * 2
                   + (torch.bool,) * 2 + (torch.int64,) * 2),
               pix=torch.int64, slot=torch.int64)

#: bytes of each per-lane field (the RNG's two words split), for drain_bytes
FIELD_BYTES = dict(o=12, d=12, throughput=12, accum=12, normal=12, t=4,
                   max_t=4, samples_done=8, bounce=8, alive=1, tracking=1,
                   rng_state=8, rng_inc=8, pix=8, slot=8)
#: a lane's exit_box flag, read and written once
EXIT_BYTES = 2
#: a round's two uint32 counts, each added to by atomics and read by the fold
ROUND_BYTES = 2 * 4 * 2
#: the PCG jump table the runs read ((2, 6 * LANES + 1) int64)
JUMP_BYTES = 2 * (6 * tpk.LANES + 1) * 8


def route(device_type: str, eager_body: bool = False) -> bool:
    """Whether the tail stage runs as the drain: on the card unless the
    caller asks for the eager loop (tests and chip_smoke.py hold the drain
    against it); the CPU runs the eager loop."""
    return device_type == "cuda" and not eager_body


def make_params(ctx):
    """(fparams, iparams) of a tail stage's context (models/fast.py
    TailContext): the tail kernel's parameter vector, then fastbody's
    values of the camera, the path-id layout, GGX, Le and epsw (read back
    once per render by fastbody.make_context), the brick grid and the
    steps per run."""
    body = ctx.body
    if body is None:
        raise ValueError("taildrain: the stage has no fastbody parameters "
                         "(render_tile builds them on the card)")
    bf, bi = body.fparams, body.iparams
    if bi[fb.IP_MULTI]:
        raise ValueError("taildrain: the tail stage is single-tile")
    f = np.zeros(N_DF, np.float32)
    i = np.zeros(N_DI, np.int64)
    f[:tpk.N_PARAMS] = _f32(ctx.params)
    for dst, src, n in (
            (DF_TILEX, fb.FP_TILEX, 2), (DF_INV_TW, fb.FP_INV_TW, 1),
            (DF_INV_RESX, fb.FP_INV_RESX, 2), (DF_CAM, fb.FP_CAM, 12),
            (DF_R2VX, fb.FP_R2VX, 2), (DF_BMAX, fb.FP_BMAX, 3),
            (DF_LE, fb.FP_LE, 3), (DF_ROUGH, fb.FP_ROUGH, 2),
            (DF_ETA, fb.FP_ETA, 1), (DF_INV_ETA, fb.FP_INV_ETA, 1),
            (DF_EPSW, fb.FP_EPSW, 1)):
        f[dst:dst + n] = bf[src:src + n]
    for dst, src in (
            (DI_SPP, fb.IP_SPP), (DI_M, fb.IP_M), (DI_NPIX, fb.IP_NPIX),
            (DI_TW, fb.IP_TW), (DI_BASE, fb.IP_BASE), (DI_SEEDH, fb.IP_SEEDH),
            (DI_BSDF, fb.IP_BSDF), (DI_MITSUBA, fb.IP_MITSUBA),
            (DI_RR, fb.IP_RR), (DI_MAXPATH, fb.IP_MAXPATH)):
        i[dst] = bi[src]
    nbz, nby, nbx = ctx.tables.dims
    i[DI_NBX], i[DI_NBY], i[DI_NBZ] = nbx, nby, nbz
    i[DI_STEPS] = ctx.pk_steps
    i[DI_CAP] = DRAIN_CAP
    return f, i


def params(ctx):
    """The context's parameter vectors (built once)."""
    if ctx.drain_params is None:
        ctx.drain_params = make_params(ctx)
    return ctx.drain_params


class Prepared(NamedTuple):
    """The arguments of drain launches, their control words, the pool
    with its fresh counters, and the host arrays and tensors the arguments
    point at (kept alive with them)."""

    args: tuple
    ctrl: torch.Tensor
    state: object
    keep: tuple


class TailDrainKernel(stages.BodyKernel):
    """The tail stage's drain, in csrc/tailpk.cu's library beside the tail
    kernel (built once, by ops/tailpk's KERNEL) and counted
    (stages.BodyKernel: `drain_launches`, `reads`, the last drain's L, E
    and launches); `reads` and `plain_rounds` also count the eager loop's
    host reads and rounds."""

    def __init__(self):
        super().__init__("taildrain", tpk._SOURCE, (N_DF, N_DI, N_S, N_CTRL),
                         has_launch=False)
        self.reset()

    def reset(self) -> None:
        """Every count to 0."""
        self.launches = self.captured = self.drain_launches = self.reads = 0
        self.enqueue_s = 0.0
        self.plain_rounds = 0
        self.last_drain = None

    def _build(self):
        return tpk.KERNEL.library()

    def _pointers(self, ctx, s, exit_box, counts, ctrl, evals):
        """The checked pointer array of a drain of the pool `s` in place."""
        R = s.alive.shape[0]
        dev = s.alive.device
        ptrs = [0] * N_S
        for k, name in enumerate(LANE_FIELDS + ("pix", "slot")):
            x = lane_field(s, name)
            shape = (R, 3) if name in _VEC3 else (R,)
            stages.check_lane("taildrain", name, x, _DTYPES[name], shape, dev)
            ptrs[k if k < N_LANE else S_PIX + k - N_LANE] = x.data_ptr()
        tables = ctx.tables
        nb = int(np.prod(tables.dims))
        jump = tpk.KERNEL.jump_table(dev)
        for slot, name, x, dtype, shape in (
                (S_EXIT, "exit_box", exit_box, torch.bool, (R,)),
                (S_COUNTS, "counts", counts, torch.float32, (3,)),
                (S_TAB, "tab", tables.tab, torch.float32, (nb, tpk.TROW)),
                (S_MAJOR, "major", tables.major, torch.float32, (nb,)),
                (S_JUMP, "jump", jump, torch.int64, (2, 6 * tpk.LANES + 1)),
                (S_CTRL, "ctrl", ctrl, torch.int64, (N_CTRL,)),
                (S_EVALS, "evals", evals, torch.int32, tuple(evals.shape))):
            stages.check_lane("taildrain", name, x, dtype, shape, dev)
            ptrs[slot] = x.data_ptr()
        return (ctypes.c_void_p * N_S)(*ptrs)

    def prepare(self, ctx, s, cap: int = DRAIN_CAP) -> Prepared:
        """The checked arguments of drain launches on the pool `s` (a
        FastState) in place, at most `cap` rounds per lane and launch."""
        dev = s.alive.device
        R = s.alive.shape[0]
        fparams, iparams = params(ctx)
        iparams = iparams.copy()
        iparams[DI_CAP] = cap
        counts = torch.stack([s.n_rays, s.n_rows, s.n_busy])
        if counts.dtype != torch.float32:
            raise ValueError("taildrain: the counters must be float32")
        s = s._replace(n_rays=counts[0], n_rows=counts[1], n_busy=counts[2])
        exit_box = torch.zeros(R, dtype=torch.bool, device=dev)
        ctrl = torch.zeros(N_CTRL, dtype=torch.int64, device=dev)
        evals = self.zeros("evals", 2 * cap, torch.int32, dev)
        addresses = self._pointers(ctx, s, exit_box, counts, ctrl, evals)
        return Prepared(self.args(fparams, iparams, addresses, R), ctrl, s,
                        (fparams, iparams, addresses, exit_box, counts))

    def launch(self, prep: Prepared) -> None:
        """One drain launch of prepared arguments on the current stream,
        counted, with no host read."""
        dev = prep.ctrl.device
        fn = self._entry(self.library(), "drain")
        with torch.cuda.device(dev):
            self._raise(fn(*prep.args, torch.cuda.current_stream(
                dev).cuda_stream), "drain")
        self.drain_launches += 1

    def drain(self, ctx, s, cap: int = DRAIN_CAP):
        """The tail stage of the pool `s` (a FastState) on the card: the
        drain launched until no lane is left, at most `cap` rounds per
        lane and launch (stages.BodyKernel.drain).  The state's per-lane
        tensors are updated in place, its counters fresh."""
        prep = self.prepare(ctx, s, cap)
        super().drain(prep.args, (), prep.ctrl, prep.ctrl.device)
        return prep.state


KERNEL = TailDrainKernel()


def run_stage(ctx, s):
    """The tail stage of the pool `s`: the plain version (models/fast.py
    plain_stage) for CPU tensors, the drain for CUDA tensors; another
    device raises."""
    dev = s.alive.device
    if dev.type == "cpu":
        from ..models import fast  # noqa: PLC0415 (cycle)

        return fast.plain_stage(ctx, s)
    if dev.type == "cuda":
        return KERNEL.drain(ctx, s)
    raise ValueError(f"taildrain: no kernel for device {dev}")


def drain_bytes(taps) -> int:
    """The least bytes the drain of a stage moves, from the taps of every
    round of its plain version (models/fast.py plain_round's lists), in
    order: each lane reads the fields its rounds read before writing them
    and writes the fields they change once (stages.state_bytes), its
    exit_box flag once each way; the distinct table words the runs tap and
    brick majorants the windows read, 4 B each; the per-round counts; the
    jump table."""
    n = stages.state_bytes(taps, FIELD_BYTES)
    ran = [x for k, x in taps if k == "round"]
    if ran:
        n += EXIT_BYTES * int(torch.stack(ran).any(0).sum())
        n += ROUND_BYTES * len(ran) + JUMP_BYTES
    for kind in ("tab", "major"):
        words = [x for k, x in taps if k == kind]
        if words:
            n += 4 * int(torch.unique(torch.cat(words)).numel())
    return n
