"""fastSK's wavefront body as one CUDA kernel (csrc/fastbody.cu).

JAX's `render_tile` (cudavolumerenderer_tpu/models/fast.py:744) runs its
`body` under a `lax.while_loop`, so XLA compiled each cascade stage into
one device program.  The port's eager body (models/fast.py, render_tile's
`body`) runs it as ~1,000 torch launches per evaluation; the kernel runs
one evaluation of every lane of a pool in one launch, bit for bit the
eager body's on the card, in every mode the eager body has: one Woodcock
step per evaluation or `spec_k` speculative steps (tail_spec), and the
boundary event inline or deferred to a flush every `defer_ggx`
evaluations (`flush_due`).

This module holds the gate (`route`), the flush schedule (`flush_due`),
the kernel's parameter vectors (`make_context`, `stage_context`), the
wrapper `run_body` (the plain version, the eager body, for CPU tensors;
the kernel for CUDA tensors, or it raises), the stage runners
(`loop_stage`, `run_stage`; gated chains in ops/stages.py, the drain in
FastBodyKernel.drain: a thread a lane for DRAIN_SPLIT evaluations, then
rounds of up to 32 evaluations a lane, `rounds_mode`, `round_tables`) and
the bound (`body_bytes`).  The kernel
updates the state's per-lane tensors in place unless it is given `out`,
and returns fresh 0-d counters (n_rays, n_rows, n_busy) and the pool's
pending count.
"""

from __future__ import annotations

import ctypes
import dataclasses
from pathlib import Path
from typing import Callable, Optional

import numpy as np
import torch

from . import stages
from .rng import M32, as_u32, jump_constants, mul32
from .stages import (C_COUNT, C_LEFT, C_LMAX, C_TOTAL, DRAIN_CAP, GATED_BATCH,
                     N_CTRL)
from .stages import f32 as _f32

_SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "fastbody.cu"

# Float parameters (csrc/fastbody.cu FP_*).
FP_TILEX, FP_TILEY, FP_INV_TW, FP_INV_RESX, FP_INV_RESY = range(5)
FP_CAM = 5  # the camera's (3, 4) inv_view, row-major
FP_R2VX = FP_CAM + 12
FP_R2VY = FP_R2VX + 1
FP_BMIN = FP_R2VY + 1
FP_BMAX = FP_BMIN + 3
FP_EXT = FP_BMAX + 3
FP_RM1 = FP_EXT + 3
FP_SCALE = FP_RM1 + 3
FP_INV_SIGMAT = FP_SCALE + 1
FP_G = FP_INV_SIGMAT + 1
FP_LE = FP_G + 1
FP_ALB_A = FP_LE + 3
FP_ALB_B = FP_ALB_A + 3
FP_QSCALE = FP_ALB_B + 3
FP_EPSW = FP_QSCALE + 1
FP_BSIZE = FP_EPSW + 1
FP_ROUGH = FP_BSIZE + 3
FP_ETA = FP_ROUGH + 2
FP_INV_ETA = FP_ETA + 1
N_FP = FP_INV_ETA + 1

# Integer parameters (csrc/fastbody.cu IP_*).
(IP_SPP, IP_M, IP_NPIX, IP_TW, IP_MULTI, IP_BASE, IP_SEEDH, IP_NX, IP_NY,
 IP_NZ, IP_TWO_LEVEL, IP_TABLE, IP_BITS, IP_BRICK_MAJOR, IP_ALBEDO,
 IP_ALB_STRIDE, IP_BSDF, IP_MITSUBA, IP_RR, IP_MAXPATH, IP_NBX, IP_NBY,
 IP_HIX, IP_HIY, IP_HIZ, IP_THRESH, IP_CHAIN, IP_CAP, IP_SPEC, IP_DEFER,
 IP_LOOK, N_IP) = range(32)

# Pointer slots (csrc/fastbody.cu S_*): the per-lane fields the body
# updates, in FastState's names, then the rest.  pend_b (S_PEND) is read
# and written only under defer_ggx.
LANE_FIELDS = ("o", "d", "throughput", "accum", "normal", "t", "max_t",
               "brick_exit", "inv_sig_local", "samples_done", "bounce",
               "alive", "tracking", "rng_state", "rng_inc", "pend_b")
N_LANE = len(LANE_FIELDS)
S_PEND = LANE_FIELDS.index("pend_b")
_DTYPES = dict(zip(LANE_FIELDS, (torch.float32,) * 9 + (torch.int64,) * 2
                   + (torch.bool,) * 2 + (torch.int64,) * 2 + (torch.bool,)),
               pix=torch.int64, slot=torch.int64)
S_PIX = N_LANE
S_SLOT, S_NRAYS, S_NROWS, S_NBUSY = S_PIX + 1, S_PIX + 2, S_PIX + 3, S_PIX + 4
S_OUT = S_NBUSY + 1
S_COUNTS = S_OUT + N_LANE
S_PENDING, S_SCRATCH = S_COUNTS + 1, S_COUNTS + 2
(S_TABLE, S_ALB_ROWS, S_BTAB, S_TILE_OFF, S_BASES, S_CTRL, S_EVALS,
 S_JUMP, S_STATS, S_RISL, S_PLANES) = range(S_SCRATCH + 1, S_SCRATCH + 12)
N_S = S_PLANES + 1
#: the drain rounds' per-lane counts (csrc/fastbody.cu ST_*, S_STATS)
ROUND_STATS = ("null_rounds", "null_evals", "chain_rounds", "chain_evals",
               "one", "chain_stops", "chain_rejects", "chain_died",
               "chain_steps", "cycles", "chain_cycles", "bank_cycles",
               "tap_cycles", "tp_cycles")

#: the most speculative steps per evaluation the kernel takes (it keeps no
#: per-candidate array, so the limit only bounds an evaluation's work)
MAX_SPEC_K = 1024

#: the drain's threads per block: a narrow pool in small blocks spreads
#: over the SMs (32, 64, 128 and 256 time alike on config 2's last pool,
#: chip_smoke.py phase 22)
DRAIN_THREADS = 32

#: the drain rounds' threads a lane (csrc/fastbody.cu DRAIN_GROUP): a warp
#: (groups of 8 and 16 lost to it on every stage timed, PERF.md)
DRAIN_GROUP = 32
#: the rounds' threads per block (blocks of 32 and 128 threads time within
#: their spread on config 2's last pool, chip_smoke.py phase 22)
DRAIN_ROUND_THREADS = 128
#: the evaluations a lane runs a thread a lane (thread_drain_kernel) before
#: the drain turns to rounds: a round costs several evaluations' time of a
#: thread a lane (its bank, taps and throughput chain), which only long
#: chains repay, and most lanes end within these (chip_smoke.py phase 22)
DRAIN_SPLIT = 256
#: the most draws an evaluation takes (u1, the tap bits, u2, e1, e2,
#: Russian roulette's), so a round's: the jump table holds m = 0 ..
#: BANK_DRAWS * 32
BANK_DRAWS = 6


def round_tables(ctx: "BodyContext", dev):
    """The drain rounds' two-level tables on `dev`: each brick's inverse
    majorant, and each axis's brick planes (x, y, then z: i = 0 .. the
    last brick + 1), computed as render_tile's probe computes them
    (`inv_new`, `bound_world` at bi + up = i, in float32), so the kernel
    reads the eager body's values; (None, None) single-level.  The planes
    are made on the host and go to `dev` in one copy with the scale."""
    if not ctx.iparams[IP_TWO_LEVEL]:
        return None, None
    f, i = ctx.fparams, ctx.iparams
    planes = [f[FP_BMIN + a] + f[FP_EXT + a] * (
        np.arange(int(i[IP_HIX + a]) + 2, dtype=np.float32)
        * f[FP_BSIZE + a]) / f[FP_RM1 + a] for a in range(3)]
    host = torch.from_numpy(np.concatenate([*planes, f[FP_SCALE:FP_SCALE + 1]]))
    host = host.to(dev)
    rho_b = ctx.brick_tab[:, 0]
    risl = torch.where(rho_b > 0.0, 1.0 / (host[-1] * torch.clamp(
        rho_b, min=1e-30)), torch.inf).contiguous()
    return risl, host[:-1]


def rounds_mode(ctx: "BodyContext") -> bool:
    """Whether a drained stage of `ctx` may turn to rounds (drain_kernel):
    spec_k 1 and no deferred flush; the other modes keep a thread a lane
    (thread_drain_kernel)."""
    return ctx.iparams[IP_SPEC] == 1 and ctx.iparams[IP_DEFER] == 0

# Table and albedo modes (IP_TABLE, IP_ALBEDO).
TAB_F32, TAB_ROWS, TAB_PACKED = range(3)
ALBEDO_MODES = {"const": 0, "affine": 1, "full": 2, "split": 3}

#: bytes of each per-lane field of the state (the RNG's two words split),
#: for body_bytes; pend_b counts only under defer_ggx (`state_fields`)
FIELD_BYTES = dict(o=12, d=12, throughput=12, accum=12, normal=12, t=4,
                   max_t=4, brick_exit=4, inv_sig_local=4, samples_done=8,
                   bounce=8, alive=1, tracking=1, rng_state=8, rng_inc=8,
                   pix=8, slot=8, pend_b=1)


def state_fields(defer_ggx: int) -> tuple:
    """The per-lane fields an evaluation may read or write: pend_b only
    under defer_ggx."""
    return tuple(k for k in FIELD_BYTES if defer_ggx > 0 or k != "pend_b")


def check_spec_k(spec_k: int) -> None:
    """Raise unless the kernel takes spec_k steps per evaluation."""
    if not 1 <= spec_k <= MAX_SPEC_K:
        raise ValueError(f"fastbody: spec_k {spec_k} is outside the kernel's "
                         f"1..{MAX_SPEC_K}")


def route(device_type: str, spec_k: int, eager_body: bool = False) -> bool:
    """Whether a stage's body evaluations go to the kernel: on the card,
    in every mode (spec_k speculative steps, the deferred GGX flush),
    unless the caller asks for the eager body (tests and chip_smoke.py
    hold the kernel against it); the CPU, which has no kernel, runs the
    eager body.  A spec_k above MAX_SPEC_K raises on the card: it is
    never sent to the eager body instead."""
    if device_type != "cuda" or eager_body:
        return False
    check_spec_k(spec_k)
    return True


def flush_due(n_rows, width: int, defer_ggx: int) -> bool:
    """Whether an evaluation of a `width`-lane pool that starts at the
    float32 row count `n_rows` first flushes the deferred boundary events:
    round(n_rows / width) % defer_ggx == 0, the division in float32 and
    the round half to even (np.round, jnp.round).  The kernel computes it
    from its float32 n_rows with IEEE division and rintf."""
    if defer_ggx <= 0:
        return False
    q = np.round(np.float32(n_rows) / np.float32(width))
    return int(q) % defer_ggx == 0


def stage_mode(device_type: str, spec_k: int, thresh: int,
               eager_body: bool = False) -> str:
    """How a cascade stage runs: "eager" where `route` keeps the eager
    body, else by the stage's exit threshold alone: "drain" at 0 (the last
    stage without the tail kernel), "gated" above it."""
    if not route(device_type, spec_k, eager_body):
        return "eager"
    return "drain" if thresh == 0 else "gated"


@dataclasses.dataclass
class BodyContext:
    """One stage's kernel inputs besides the state: the parameter
    vectors (host numpy), the read-only tensors (None where a mode reads
    none) and the eager body with the stage's keywords (the plain
    version; it takes an optional `taps` list, see body_bytes)."""

    fparams: np.ndarray  # (N_FP,) float32
    iparams: np.ndarray  # (N_IP,) int64
    table: torch.Tensor
    albedo_rows: Optional[torch.Tensor]
    brick_tab: Optional[torch.Tensor]
    tile_offset: Optional[torch.Tensor]  # (T, 2), multi-tile mode
    bases: Optional[torch.Tensor]  # (T,) int64, multi-tile mode
    plain: Optional[Callable] = None


def make_context(scene, camera, settings, full_resolution, tile_dim,
                 tile_offset, path_id_base, seed, *, spp_per_lane: int,
                 m: int, n_pix_tile: int, res_minus_1, extent, inv_sigmat,
                 epsw, two_level: bool, table: torch.Tensor, table_bits: int,
                 brick_major: bool, albedo_mode: str,
                 albedo_rows: Optional[torch.Tensor],
                 defer_ggx: int = 0) -> BodyContext:
    """The kernel's parameters from the values render_tile computes (the
    same tensors, read back to the host once per render): the brick
    fields stay 0, and spec_k 1, until `stage_context` fills them.  A
    division by a Python scalar runs on the card as a multiplication by
    the scalar's float32 reciprocal, so those reciprocals are what the
    vector holds."""
    med = scene.medium
    nz, ny, nx = med.density.data.shape
    tw = int(tile_dim[0])
    multi = tile_offset.ndim == 2
    f = np.zeros(N_FP, np.float32)
    i = np.zeros(N_IP, np.int64)
    one = np.float32(1.0)
    if not multi:
        f[FP_TILEX:FP_TILEY + 1] = _f32(tile_offset)
    f[FP_INV_TW] = one / np.float32(tw)
    f[FP_INV_RESX] = one / np.float32(float(full_resolution[0]))
    f[FP_INV_RESY] = one / np.float32(float(full_resolution[1]))
    f[FP_CAM:FP_CAM + 12] = _f32(camera.inv_view)
    f[FP_R2VX:FP_R2VY + 1] = _f32(camera.raster_to_view)
    f[FP_BMIN:FP_BMIN + 3] = _f32(med.box_min)
    f[FP_BMAX:FP_BMAX + 3] = _f32(med.box_max)
    f[FP_EXT:FP_EXT + 3] = _f32(extent)
    f[FP_RM1:FP_RM1 + 3] = _f32(res_minus_1)
    f[FP_SCALE] = _f32(med.scale)[0]
    f[FP_INV_SIGMAT] = _f32(inv_sigmat)[0]
    f[FP_G] = _f32(med.g)[0]
    f[FP_LE:FP_LE + 3] = _f32(scene.le)
    if albedo_mode == "const":
        f[FP_ALB_B:FP_ALB_B + 3] = _f32(med.albedo.data.reshape(-1)[:3])
    elif albedo_mode == "affine":
        f[FP_ALB_A:FP_ALB_A + 3] = _f32(med.albedo_affine[0])
        f[FP_ALB_B:FP_ALB_B + 3] = _f32(med.albedo_affine[1])
    if table_bits in (8, 4) and albedo_mode != "full":
        # packed_take's dequantizing factor, as the eager op computes it
        f[FP_QSCALE] = _f32(med.max_density / float((1 << table_bits) - 1))[0]
    f[FP_EPSW] = _f32(epsw)[0]
    f[FP_ROUGH:FP_ROUGH + 2] = _f32(scene.bsdf.roughness)
    f[FP_ETA] = _f32(scene.bsdf.eta)[0]
    f[FP_INV_ETA] = one / f[FP_ETA]

    i[IP_SPP], i[IP_M], i[IP_NPIX], i[IP_TW] = spp_per_lane, m, n_pix_tile, tw
    i[IP_MULTI] = int(multi)
    if not multi:
        i[IP_BASE] = int(path_id_base) & M32
    seed_u = as_u32(seed if isinstance(seed, torch.Tensor) else int(seed))
    i[IP_SEEDH] = int(mul32(seed_u.cpu(), 0x9E3779B9))
    i[IP_NX], i[IP_NY], i[IP_NZ] = nx, ny, nz
    i[IP_TWO_LEVEL] = int(two_level)
    if albedo_mode == "full":
        i[IP_TABLE] = TAB_ROWS
    elif table_bits in (8, 4):
        i[IP_TABLE], i[IP_BITS] = TAB_PACKED, table_bits
    i[IP_BRICK_MAJOR] = int(brick_major)
    i[IP_ALBEDO] = ALBEDO_MODES[albedo_mode]
    if albedo_rows is not None:
        i[IP_ALB_STRIDE] = albedo_rows.shape[-1]
    i[IP_BSDF] = int(settings.bsdf_kind == "ggx")
    i[IP_MITSUBA] = int(settings.mitsuba_comparable)
    i[IP_RR] = int(settings.russian_roulette)
    i[IP_MAXPATH] = settings.max_path_length
    i[IP_SPEC], i[IP_DEFER] = 1, defer_ggx
    dev = table.device
    return BodyContext(
        fparams=f, iparams=i, table=table, albedo_rows=albedo_rows,
        brick_tab=None,
        tile_offset=(tile_offset.to(dev, torch.float32).contiguous()
                     if multi else None),
        bases=((torch.as_tensor(path_id_base, dtype=torch.int64,
                                device=dev) & M32).contiguous()
               if multi else None),
    )


def stage_context(ctx: BodyContext, bt: Optional[dict], single_level: bool,
                  plain: Callable, spec_k: int = 1) -> BodyContext:
    """`ctx` for one stage: two-level with the brick table `bt` (the
    coarse or the tail's fine one) unless single_level, spec_k Woodcock
    steps per evaluation (a candidate valid strictly before a brick exit
    two-level, up to the box's max_t single-level: speculate's `strict`),
    and the plain evaluation with the stage's keywords."""
    check_spec_k(spec_k)
    f, i = ctx.fparams.copy(), ctx.iparams.copy()
    two = bool(i[IP_TWO_LEVEL]) and not single_level and bt is not None
    i[IP_TWO_LEVEL] = int(two)
    i[IP_SPEC] = spec_k
    brick_tab = None
    if two:
        f[FP_BSIZE:FP_BSIZE + 3] = _f32(bt["size"])
        i[IP_HIX:IP_HIZ + 1] = bt["hi"].cpu().numpy()
        i[IP_NBX], i[IP_NBY] = bt["nbx"], bt["nby"]
        brick_tab = bt["tab"].contiguous()
    return dataclasses.replace(ctx, fparams=f, iparams=i, brick_tab=brick_tab,
                               plain=plain)


#: the stage modes counted apart (FastBodyKernel.by_mode): speculative
#: steps (spec_k > 1) and the deferred GGX flush (defer_ggx > 0)
MODES = ("spec", "defer")


def modes_of(ctx: BodyContext) -> tuple:
    """The MODES a stage of `ctx` runs in."""
    return tuple(m for m, on in zip(MODES, (ctx.iparams[IP_SPEC] > 1,
                                            ctx.iparams[IP_DEFER] > 0)) if on)


class FastBodyKernel(stages.BodyKernel):
    """The CUDA body kernels, built from csrc/fastbody.cu at first use and
    counted (stages.BodyKernel, and by_mode); `last_drain` also holds the
    drain's block size, and `plain_evals` counts render_tile's evaluations
    of the eager body (the CPU's, or eager_body=True on the card)."""

    def __init__(self):
        super().__init__("fastbody", _SOURCE, (N_FP, N_IP, N_S, N_CTRL),
                         drain_argtypes=(ctypes.c_int,))
        self._jumps = {}
        self.reset()

    def jump_table(self, dev) -> torch.Tensor:
        """The drain rounds' PCG jump table on `dev` (rng.jump_constants:
        the state after m draws, m = 0 .. BANK_DRAWS * 32), made once."""
        if dev not in self._jumps:
            self._jumps[dev] = jump_constants(BANK_DRAWS * 32).to(dev)
        return self._jumps[dev]

    def reset(self) -> None:
        """Every count to 0."""
        self.launches = self.captured = self.drain_launches = self.reads = 0
        self.enqueue_s = 0.0
        self.last_drain = None
        #: launches (one-evaluation and drain) of stages in each mode
        self.by_mode = dict.fromkeys(MODES, 0)
        self.plain_evals = 0

    def _count_modes(self, ctx: BodyContext, before: int) -> None:
        """Add the launches made since `before` (launches + drain
        launches) to the modes of ctx's stage."""
        n = self.launches + self.drain_launches - before
        for mode in modes_of(ctx):
            self.by_mode[mode] += n

    def _pointers(self, ctx: BodyContext, s, out, counts, pending, ctrl=None,
                  evals=None, jumps=None, stats=None, tables=(None, None)):
        """The checked pointer array of launches on `s` that write `out`'s
        per-lane tensors, read s's counters (n_rays, n_rows, n_busy), write
        the new ones to the (3,) float32 `counts` and the pending count to
        `pending` (a 0-d int64 tensor, or None)."""
        width = s.alive.shape[0]
        dev = s.alive.device
        fields = [stages.lane_field(s, name) for name in LANE_FIELDS]
        outs = [stages.lane_field(out, name) for name in LANE_FIELDS]
        for name, x, y in zip(LANE_FIELDS, fields, outs):
            _check(name, x, width, dev)
            if y is not x:
                _check(name, y, width, dev)
                if stages.overlaps(x, y):
                    raise ValueError(
                        f"fastbody: out.{name} overlaps the input partly")
        for name in ("pix", "slot"):
            _check(name, getattr(s, name), width, dev)
        for name in ("n_rays", "n_rows", "n_busy"):
            x = getattr(s, name)
            if x.device != dev or x.dtype != torch.float32 or x.ndim != 0:
                raise ValueError(f"fastbody: {name} must be a 0-d float32 "
                                 f"tensor on {dev}")
        for name in ("table", "albedo_rows", "brick_tab", "tile_offset",
                     "bases"):
            x = getattr(ctx, name)
            if x is not None and (x.device != dev or not x.is_contiguous()):
                raise ValueError(f"fastbody: {name} must be contiguous on "
                                 f"{dev}")
        ptrs = [0] * N_S
        for k, x in enumerate(fields):
            ptrs[k] = x.data_ptr()
        for k, x in enumerate(outs):
            ptrs[S_OUT + k] = x.data_ptr()
        ptrs[S_PIX], ptrs[S_SLOT] = s.pix.data_ptr(), s.slot.data_ptr()
        ptrs[S_NRAYS] = s.n_rays.data_ptr()
        ptrs[S_NROWS] = s.n_rows.data_ptr()
        ptrs[S_NBUSY] = s.n_busy.data_ptr()
        ptrs[S_COUNTS] = counts.data_ptr()
        ptrs[S_PENDING] = 0 if pending is None else pending.data_ptr()
        ptrs[S_SCRATCH] = self.zeros("scratch", 4, torch.int64, dev).data_ptr()
        for slot_, x in ((S_TABLE, ctx.table), (S_ALB_ROWS, ctx.albedo_rows),
                         (S_BTAB, ctx.brick_tab), (S_TILE_OFF, ctx.tile_offset),
                         (S_BASES, ctx.bases), (S_CTRL, ctrl),
                         (S_EVALS, evals), (S_JUMP, jumps),
                         (S_STATS, stats), (S_RISL, tables[0]),
                         (S_PLANES, tables[1])):
            ptrs[slot_] = 0 if x is None else x.data_ptr()
        return (ctypes.c_void_p * N_S)(*ptrs)

    def launch(self, ctx: BodyContext, s, out=None):
        """One body evaluation of every lane of `s` (a FastState): the new
        state (its per-lane tensors `out`'s, or `s`'s, updated in place)
        and the pool's pending count as a 0-d int64 tensor."""
        dev = s.alive.device
        out = s if out is None else out
        counts = torch.empty(3, dtype=torch.float32, device=dev)
        pending = torch.empty((), dtype=torch.int64, device=dev)
        addresses = self._pointers(ctx, s, out, counts, pending)
        before = self.launches + self.drain_launches
        self.launch_one(self.args(ctx.fparams, ctx.iparams, addresses,
                                  s.alive.shape[0]), dev)
        self._count_modes(ctx, before)
        # without defer_ggx the kernel leaves pend_b alone
        pend_b = out.pend_b if ctx.iparams[IP_DEFER] else s.pend_b
        new = out._replace(pix=s.pix, slot=s.slot, pend_b=pend_b,
                           n_rays=counts[0], n_rows=counts[1],
                           n_busy=counts[2])
        return new, pending

    def gated(self, ctx: BodyContext, s, thresh: int, k_chain: int,
              batch: int = GATED_BATCH):
        """A stage whose loop exits at a chain boundary once the pending
        count is at most `thresh` (> 0), in gated chains
        (stages.BodyKernel.gated): the state (its per-lane tensors updated
        in place, its counters fresh) and its evaluations."""
        dev = s.alive.device
        spp = int(ctx.iparams[IP_SPP])
        counts = torch.stack([s.n_rays, s.n_rows, s.n_busy])
        s = s._replace(n_rays=counts[0], n_rows=counts[1], n_busy=counts[2])
        ctrl = torch.zeros(N_CTRL, dtype=torch.int64, device=dev)
        ctrl[C_COUNT] = torch.count_nonzero(s.alive | (s.samples_done < spp))
        iparams = ctx.iparams.copy()
        iparams[IP_THRESH], iparams[IP_CHAIN] = thresh, k_chain
        addresses = self._pointers(ctx, s, s, counts, ctrl[C_COUNT], ctrl)
        before = self.launches + self.drain_launches
        n = super().gated(
            self.args(ctx.fparams, iparams, addresses, s.alive.shape[0]),
            ctrl, thresh, k_chain, dev, batch)
        self._count_modes(ctx, before)
        return s, n

    def drain(self, ctx: BodyContext, s, k_chain: int,
              cap: int = DRAIN_CAP, threads: Optional[int] = None,
              once: bool = False, split: Optional[int] = DRAIN_SPLIT,
              stats: Optional[torch.Tensor] = None):
        """The last stage without the tail kernel (its loop exits at a
        pending count of 0), drained like stages.BodyKernel.drain: a thread
        a lane for its first `split` evaluations (thread_drain_kernel, at
        DRAIN_THREADS a block; 0: none), then, with lanes left, in rounds by
        DRAIN_GROUP threads a lane in blocks of `threads` (None:
        DRAIN_ROUND_THREADS), at most `cap` evaluations a launch.  Where
        `rounds_mode` allows no rounds, or with split None, a thread a lane
        throughout, `threads` a block (None: DRAIN_THREADS).  With `once`
        one launch; a zeroed (width, len(ROUND_STATS)) int32 `stats`
        receives each lane's rounds (csrc/fastbody.cu ST_*; only such a
        launch keeps them).  Returns the state (its per-lane tensors updated
        in place, its counters fresh) and the loop's evaluations E
        (last_drain, which also holds each launch's group and threads)."""
        dev = s.alive.device
        width = s.alive.shape[0]
        group = DRAIN_GROUP if split is not None and rounds_mode(ctx) else 0
        counts = torch.stack([s.n_rays, s.n_rows, s.n_busy])
        s = s._replace(n_rays=counts[0], n_rows=counts[1], n_busy=counts[2])
        ctrl = torch.zeros(N_CTRL, dtype=torch.int64, device=dev)
        evals = self.zeros("evals", 2 * max(cap, split or 0), torch.int32,
                           dev)
        plan = [(group, cap, threads or (
            DRAIN_ROUND_THREADS if group else DRAIN_THREADS))]
        if group and split > 0:  # a thread a lane first
            plan.insert(0, (0, min(split, cap), DRAIN_THREADS))
        fn = self._entry(self.library(), "drain")
        stream = torch.cuda.current_stream(dev).cuda_stream
        before = self.launches + self.drain_launches
        launched, tables = [], None
        while True:
            g, cap_k, threads_k = plan[min(len(launched), len(plan) - 1)]
            iparams = ctx.iparams.copy()
            iparams[IP_CHAIN], iparams[IP_CAP] = k_chain, cap_k
            iparams[IP_LOOK] = g
            if g and tables is None:
                tables = round_tables(ctx, dev)
            addresses = self._pointers(
                ctx, s, s, counts, None, ctrl, evals,
                self.jump_table(dev) if g else None, stats if g else None,
                tables if g else (None, None))
            with torch.cuda.device(dev):
                self._raise(fn(*self.args(ctx.fparams, iparams, addresses,
                                          width), threads_k, stream), "drain")
            self.drain_launches += 1
            launched.append((g, threads_k))
            words = self.read(ctrl)
            if words[C_LEFT] == 0 or once:
                break
        self._count_modes(ctx, before)
        self.last_drain = {"L": words[C_LMAX], "E": words[C_TOTAL],
                           "launches": len(launched), "left": words[C_LEFT],
                           "group": launched[-1][0],
                           "threads": launched[-1][1], "plan": launched}
        return s, self.last_drain["E"]


def _check(name, x, width, dev):
    shape = (width, 3) if name in LANE_FIELDS[:5] else (width,)
    stages.check_lane("fastbody", name, x, _DTYPES[name], shape, dev)


KERNEL = FastBodyKernel()


def run_body(ctx: BodyContext, s, out=None):
    """One body evaluation of the pool `s`: the plain version (the eager
    body) for CPU tensors, the CUDA kernel for CUDA tensors.  Returns the
    new state and the pool's pending count as a 0-d tensor, or None when
    the plain version ran (the caller counts)."""
    dev = s.alive.device
    if dev.type == "cpu":
        return ctx.plain(s), None
    if dev.type == "cuda":
        return KERNEL.launch(ctx, s, out)
    raise ValueError(f"fastbody: no kernel for device {dev}")


def pending_count(s, spp: int) -> int:
    """The pool's pending lanes (a path in flight or samples left), read
    to the host."""
    return int(torch.count_nonzero(s.alive | (s.samples_done < spp)))


def loop_stage(ctx: BodyContext, s, thresh: int, k_chain: int):
    """The plain version of a stage (stages.loop_chains): chains of
    k_chain `run_body` evaluations while the pending count exceeds
    `thresh`, the count read at each chain's end (the kernel's, or counted
    here on the CPU; each read counts in KERNEL.reads).  Returns the state
    and its evaluations."""
    spp = int(ctx.iparams[IP_SPP])
    return stages.loop_chains(
        KERNEL, s, lambda x: pending_count(x, spp),
        lambda x: run_body(ctx, x), thresh, k_chain)


def run_stage(ctx: BodyContext, s, thresh: int, k_chain: int, last: bool):
    """One cascade stage of render_tile: the state once the loop of body
    evaluations would exit (the pending count at most `thresh` at a chain
    boundary), and its evaluations (known to the host from the reads the
    stage makes anyway).  On the CPU `loop_stage`; on the card as
    `stage_mode` says: the drain for a threshold of 0 (only the last stage
    has it) and gated chains above it, both equal to `loop_stage` bit for
    bit.  The kernels update the state's per-lane tensors in place."""
    if s.alive.device.type != "cuda":  # another device raises in run_body
        return loop_stage(ctx, s, thresh, k_chain)
    if stage_mode("cuda", int(ctx.iparams[IP_SPEC]), thresh) == "drain":
        if not last:
            raise ValueError("fastbody: only the last stage drains")
        return KERNEL.drain(ctx, s, k_chain)
    return KERNEL.gated(ctx, s, thresh, k_chain)


def body_bytes(ctx: BodyContext, taps) -> int:
    """The least bytes the evaluations whose `taps` are given move (the
    lists the eager body fills: ("state", stages.lane_traffic), and ("tap",
    flat indices), ("brick", brick rows) of the lanes that read them):
    each lane reads the fields its evaluation reads (a dead lane with no
    sample left its alive flag and sample count alone) and writes the
    fields it changes, and the distinct table entries are read once.
    Given the taps of every evaluation of a drained stage, in order, the
    drain's: a lane's field is read once, unless an earlier evaluation
    wrote it, and written once."""
    kind = int(ctx.iparams[IP_TABLE])
    tap_idx = [x for k, x in taps if k == "tap"]
    bricks = [x for k, x in taps if k == "brick"]
    n = stages.state_bytes(taps, FIELD_BYTES)
    if tap_idx:
        j = torch.cat(tap_idx)
        if kind == TAB_PACKED:
            per = 32 // int(ctx.iparams[IP_BITS])
            j = ((j >> 7) // per) * 128 + (j & 127)  # the words read
        n += torch.unique(j).numel() * (16 if kind == TAB_ROWS else 4)
    if bricks:
        n += torch.unique(torch.cat(bricks)).numel() * 8
    return n
