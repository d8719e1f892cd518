"""tailPK: the persistent tail kernel of the fastSK cascade.

Port of cudavolumerenderer_tpu/ops/pallas/tailpk.py.  The Pallas TPU
kernel becomes a hand-written CUDA kernel (csrc/tailpk.cu, design notes
there); this module holds its plain PyTorch version `tail_steps`, the
wrapper `run_tail_steps` that picks between them by the tensors' device,
and the host-side tables.

For each deep path the kernel runs K whole Woodcock steps inside the
path's dilated 16^3 brick window (17^3 voxels): a flight draw under the
brick majorant, a stochastic-trilinear tap, the acceptance test, and on
a scatter the HG direction, albedo A*rho+B, bounce+1, the path cap and
Russian roulette, then the re-derived box exit (aabb tie-break order)
and DDA brick exit.  A path leaves with status NEED_WINDOW (crossed its
brick), EXIT_BOX (boundary event due) or DEAD (RR kill or path cap);
models/fast.py's service loop handles those.

Layout.  The TPU kernel took per-path (R, 128) lane broadcasts and a
gathered (R, 39, 128) copy of each path's window.  Here per-path state
is (rows, R) structure-of-arrays, and the kernel reads the shared
(NB, 4992) dilated-brick table at a per-path brick index.

Per step a path draws, from its own PCG stream: u1 (flight); then for a
step that stays in its brick the tap bits and u2 (acceptance); then on a
scatter e1, e2 (HG) and, with Russian roulette on, the RR uniform — the
draw pattern of the wavefront body.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..constants import EPSILON, TWO_PI
from . import aabb
from .rng import RngState, next_uint32

# Tail brick geometry: 16^3 interior, 17^3 dilated, rows of 39 x 128.
TBRICK = 16
TDIL = TBRICK + 1  # 17
TVOX = TDIL * TDIL * TDIL  # 4913
TROW = -(-TVOX // 128) * 128  # 4992

# Lane status codes.
RUN = 0
NEED_WINDOW = 1
EXIT_BOX = 2
DEAD = 3

# Parameter vector layout ((N_PARAMS,) float32).
P_SCALE = 0
P_G = 1
P_AR, P_AG, P_AB = 2, 3, 4  # albedo = A * rho + B per channel
P_BR, P_BG, P_BB = 5, 6, 7
P_BMINX, P_BMINY, P_BMINZ = 8, 9, 10
P_EXTX, P_EXTY, P_EXTZ = 11, 12, 13
P_RM1X, P_RM1Y, P_RM1Z = 14, 15, 16  # res - 1 per axis (float)
P_MAXPATH = 17
P_RR = 18  # 0/1 russian roulette
P_NX, P_NY, P_NZ = 19, 20, 21  # grid dims (float)
N_PARAMS = 22

# Float state rows ((N_F, R) float32), the TPU kernel's argument order.
(F_OX, F_OY, F_OZ, F_DX, F_DY, F_DZ, F_TR, F_TG, F_TB, F_T, F_MAXT,
 F_BEXIT, F_INVSIG, F_RHOMAX, F_NX, F_NY, F_NZ) = range(17)
N_F = 17
# Int state rows ((N_I, R) int32): brick origin in voxels, bounce, status.
I_WX, I_WY, I_WZ, I_BOUNCE, I_STATUS = range(5)
N_I = 5

_SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "tailpk.cu"


class TailTables(NamedTuple):
    tab: torch.Tensor  # (NB, TROW) float32 dilated 17^3 windows
    major: torch.Tensor  # (NB,) float32 dilated majorants
    dims: Tuple[int, int, int]  # (nbz, nby, nbx)


def dilated_tail_bricks(density_zyx: torch.Tensor) -> TailTables:
    """Dilated 16^3-brick table, its majorants and the brick-grid dims.

    Entry b holds the 17^3 voxels [org, org+16]^3 (zero pad past the
    high edge), x-fastest, flat (lz*17+ly)*17+lx, zero-padded to TROW."""
    from ..models.fast import brick_majorants  # noqa: PLC0415 (cycle)

    d = density_zyx.to(torch.float32)
    nz, ny, nx = d.shape
    nbz, nby, nbx = -(-nz // TBRICK), -(-ny // TBRICK), -(-nx // TBRICK)
    pad = F.pad(
        d,
        (0, nbx * TBRICK + 1 - nx, 0, nby * TBRICK + 1 - ny,
         0, nbz * TBRICK + 1 - nz),
    )
    win = (
        pad.unfold(0, TDIL, TBRICK).unfold(1, TDIL, TBRICK)
        .unfold(2, TDIL, TBRICK)  # (nbz, nby, nbx, 17z, 17y, 17x)
        .reshape(nbz * nby * nbx, TVOX)
    )
    tab = F.pad(win, (0, TROW - TVOX))
    major = brick_majorants(d, (TBRICK, TBRICK, TBRICK)).reshape(-1)
    return TailTables(tab=tab, major=major, dims=(nbz, nby, nbx))


def brick_window(o, d, t, box_min, extent, res_minus_1, dims, major, scale):
    """Tail brick of each path at o + (t + eps) d and what the kernel
    needs of it: (brick index, brick origin in voxels (R, 3) xyz, 1/sigma
    under the brick majorant, the majorant, the DDA brick exit)."""
    nbz, nby, nbx = dims
    epsw = torch.amax(extent) * 1e-6
    p_now = o + (t + epsw)[:, None] * d
    coord = torch.clamp((p_now - box_min) / extent, 0.0, 1.0) * res_minus_1
    hi = torch.tensor([nbx - 1, nby - 1, nbz - 1], device=o.device)
    bi = torch.minimum(
        torch.clamp(torch.floor(coord / float(TBRICK)).to(torch.int64), min=0),
        hi,
    )
    bflat = (bi[:, 2] * nby + bi[:, 1]) * nbx + bi[:, 0]
    rho_b = major[bflat]
    inv_sig = torch.where(
        rho_b > 0.0, 1.0 / (scale * torch.clamp(rho_b, min=1e-30)), torch.inf
    )
    worg = bi * TBRICK
    up = (d > 0.0).to(torch.float32)
    bound_vox = worg.to(torch.float32) + up * TBRICK
    bound_world = box_min + extent * bound_vox / res_minus_1
    okd = torch.abs(d) > 1e-12
    t_axes = torch.where(
        okd, (bound_world - o) / torch.where(okd, d, 1.0), torch.inf
    )
    bexit = torch.maximum(torch.amin(t_axes, dim=-1), t + epsw)
    return bflat, worg, inv_sig, rho_b, bexit


def _uniform(bits: torch.Tensor) -> torch.Tensor:
    return (bits >> 8).to(torch.float32) * (1.0 / (1 << 24))


def tail_steps(tab, brick, params, f, i, rng, n_steps: int, taps=None):
    """Plain PyTorch version of the tail kernel: n_steps masked steps on
    R paths, every lane in lockstep, with the kernel's signature.

    tab (NB, TROW) f32; brick (R,) int64; params (N_PARAMS,) f32;
    f (N_F, R) f32; i (N_I, R) int32; rng (2, R) int64 (state, inc) holding
    uint32 words.  Returns (f_out (N_F, R) f32, i_out (2, R) int32 of
    bounce and status, rng_state_out (R,) int64).  A list given as `taps`
    receives, per step, the flat table positions that step reads."""
    P = params
    scale, g = P[P_SCALE], P[P_G]
    alb_a = (P[P_AR], P[P_AG], P[P_AB])
    alb_b = (P[P_BR], P[P_BG], P[P_BB])
    bmin = (P[P_BMINX], P[P_BMINY], P[P_BMINZ])
    ext = (P[P_EXTX], P[P_EXTY], P[P_EXTZ])
    rm1 = (P[P_RM1X], P[P_RM1Y], P[P_RM1Z])
    max_path, rr_on = P[P_MAXPATH], P[P_RR]
    ngrid = [P[k].to(torch.int64) for k in (P_NX, P_NY, P_NZ)]
    epsw = torch.maximum(torch.maximum(ext[0], ext[1]), ext[2]) * 1e-6

    o = [f[F_OX], f[F_OY], f[F_OZ]]
    dv = [f[F_DX], f[F_DY], f[F_DZ]]
    tp = [f[F_TR], f[F_TG], f[F_TB]]
    nrm = [f[F_NX], f[F_NY], f[F_NZ]]
    t, max_t, bexit = f[F_T], f[F_MAXT], f[F_BEXIT]
    inv_sig = f[F_INVSIG]
    worg = [i[I_WX].to(torch.int64), i[I_WY].to(torch.int64),
            i[I_WZ].to(torch.int64)]
    bounce = i[I_BOUNCE].to(torch.int64)
    status = i[I_STATUS].to(torch.int64)
    st = RngState(state=rng[0], inc=rng[1])

    for _ in range(n_steps):
        active = status == RUN

        # ---- flight draw ------------------------------------------------
        bits1, st = next_uint32(st, active)
        step = -torch.log(torch.clamp(_uniform(bits1), min=EPSILON)) * inv_sig
        t_cand = t + step
        eff_exit = torch.minimum(bexit, max_t)
        crossed = active & (t_cand >= eff_exit)
        box_closer = max_t <= bexit
        status = torch.where(
            crossed, torch.where(box_closer, EXIT_BOX, NEED_WINDOW), status
        )
        # crossing lands on the exit plane; EXIT_BOX parks at max_t
        t = torch.where(
            crossed, torch.where(box_closer, max_t, bexit),
            torch.where(active, t_cand, t),
        )
        inside = active & ~crossed

        # ---- stochastic-trilinear tap -----------------------------------
        bits2, st = next_uint32(st, inside)
        local = []
        for a in range(3):
            c = torch.clamp((o[a] + t * dv[a] - bmin[a]) / ext[a], 0.0, 1.0)
            c = c * rm1[a]
            u = ((bits2 >> (10 * a)) & 0x3FF).to(torch.float32) * (1.0 / 1024.0)
            fl = torch.floor(c)
            tap = fl.to(torch.int64) + (u < c - fl).to(torch.int64)
            tap = torch.minimum(torch.clamp(tap, min=0), ngrid[a] - 1)
            local.append(torch.clamp(tap - worg[a], 0, TDIL - 1))
        flat = (local[2] * TDIL + local[1]) * TDIL + local[0]
        rho = tab[brick, flat]
        if taps is not None:
            taps.append((brick * TROW + flat)[inside])

        # ---- acceptance -------------------------------------------------
        bits3, st = next_uint32(st, inside)
        accepted = inside & ~(scale * rho * inv_sig < _uniform(bits3))

        # ---- scatter event ----------------------------------------------
        e1b, st = next_uint32(st, accepted)
        e2b, st = next_uint32(st, accepted)
        e1, e2 = _uniform(e1b), _uniform(e2b)
        # HG sampling (ops/phase.importance_sample_hg formulas)
        sqr = (1.0 - g * g) / torch.clamp(1.0 - g + 2.0 * g * e1, min=1e-12)
        g_safe = torch.where(torch.abs(g) > 1e-12, g, 1.0)
        cos_a = (1.0 + g * g - sqr * sqr) / (2.0 * g_safe)
        cos_i = 1.0 - 2.0 * e1
        cos_th = torch.clamp(
            torch.where(torch.abs(g) > EPSILON, cos_a, cos_i), -1.0, 1.0
        )
        sin_th = torch.sqrt(torch.clamp(1.0 - cos_th * cos_th, min=0.0))
        phi = TWO_PI * e2
        # local basis (ops/math3.local_basis)
        dx, dy, dz = dv
        inv_n1 = 1.0 / torch.sqrt(torch.clamp(dx * dx + dz * dz, min=1e-12))
        v1 = (dz * inv_n1, torch.zeros_like(dx), -dx * inv_n1)
        v2 = (
            dy * v1[2] - dz * v1[1],
            dz * v1[0] - dx * v1[2],
            dx * v1[1] - dy * v1[0],
        )
        cp, sp = torch.cos(phi), torch.sin(phi)
        sc = accepted
        nd = [
            sin_th * cp * v1[a] + sin_th * sp * v2[a] + cos_th * dv[a]
            for a in range(3)
        ]
        o = [torch.where(sc, o[a] + dv[a] * t - dv[a] * EPSILON, o[a])
             for a in range(3)]
        tp = [torch.where(sc, tp[a] * (alb_a[a] * rho + alb_b[a]), tp[a])
              for a in range(3)]
        dv = [torch.where(sc, nd[a], dv[a]) for a in range(3)]
        bounce = torch.where(sc, bounce + 1, bounce)

        # path-length cap, then Russian roulette (body() order)
        capped = sc & (bounce.to(torch.float32) >= max_path)
        status = torch.where(capped, DEAD, status)
        rr_mask = sc & ~capped & (rr_on > 0.5)
        p_surv = torch.clamp(
            torch.maximum(torch.maximum(tp[0], tp[1]), tp[2]), max=1.0
        )
        rr_bits, st = next_uint32(st, rr_mask)
        killed = rr_mask & (_uniform(rr_bits) > p_surv)
        status = torch.where(killed, DEAD, status)
        survived = rr_mask & ~killed
        inv_p = 1.0 / torch.clamp(p_surv, min=1e-20)
        tp = [torch.where(survived, tp[a] * inv_p, tp[a]) for a in range(3)]

        # surviving scatter: restart the segment from the new pose — box
        # exit + face normal (aabb_intersect semantics), DDA brick exit
        seg = sc & ~capped & ~killed
        ttop, tbot = [], []
        for a in range(3):
            inv = 1.0 / dv[a]
            tbot.append((bmin[a] - o[a]) * inv)
            ttop.append((bmin[a] + ext[a] - o[a]) * inv)
        tmin = [torch.minimum(ttop[a], tbot[a]) for a in range(3)]
        tmax = [torch.maximum(ttop[a], tbot[a]) for a in range(3)]
        largest_tmin = torch.maximum(torch.maximum(tmin[0], tmin[1]), tmin[2])
        smallest_tmax = torch.minimum(torch.minimum(tmax[0], tmax[1]), tmax[2])
        dist = torch.where(largest_tmin > EPSILON, largest_tmin, smallest_tmax)
        new_n = [torch.zeros_like(dist) for _ in range(3)]
        taken = torch.zeros_like(seg)
        for plane, axis, sign in (
            (ttop[0], 0, 1.0), (ttop[1], 1, 1.0), (ttop[2], 2, 1.0),
            (tbot[0], 0, -1.0), (tbot[1], 1, -1.0), (tbot[2], 2, -1.0),
        ):
            match = ~taken & (dist == plane)
            new_n[axis] = torch.where(match, sign, new_n[axis])
            taken = taken | match
        max_t = torch.where(seg, dist, max_t)
        nrm = [torch.where(seg, new_n[a], nrm[a]) for a in range(3)]
        t = torch.where(seg, 0.0, t)
        exit_t = torch.full_like(t, torch.inf)
        for a in range(3):
            up = (dv[a] > 0.0).to(torch.float32)
            bound_vox = worg[a].to(torch.float32) + up * float(TBRICK)
            bound_world = bmin[a] + ext[a] * bound_vox / rm1[a]
            okd = torch.abs(dv[a]) > 1e-12
            t_axis = torch.where(
                okd, (bound_world - o[a]) / torch.where(okd, dv[a], 1.0),
                torch.inf,
            )
            exit_t = torch.minimum(exit_t, t_axis)
        bexit = torch.where(
            seg, torch.maximum(exit_t, torch.zeros_like(t) + epsw), bexit
        )

    f_out = torch.stack(
        [*o, *dv, *tp, t, max_t, bexit, inv_sig, f[F_RHOMAX], *nrm]
    )
    i_out = torch.stack([bounce, status]).to(torch.int32)
    return f_out, i_out, st.state


#: integer and float operations a kernel step that taps the table does at
#: least (csrc/tailpk.cu): the flight draw, the three-axis tap and the
#: acceptance draw, each PCG draw 9 operations; a scatter adds more
STEP_OPS = 60


def tail_bytes(n_paths: int, table_words: int) -> int:
    """The least bytes one kernel call moves: every state row of R paths
    read (f, i, rng, brick) and written (f_out, i_out, rng_out) once, the
    parameter vector, and the `table_words` distinct table words its taps
    read (data-dependent: count them with `tail_steps(..., taps=)`)."""
    read = (N_F * 4 + N_I * 4 + 2 * 8 + 8) * n_paths + N_PARAMS * 4
    written = (N_F * 4 + 2 * 4 + 8) * n_paths
    return read + written + 4 * table_words


class TailKernel:
    """The CUDA tail kernel: built from csrc/tailpk.cu at first use,
    launched through its C entry point, and counted.  `launches` counts
    launches made now; a launch recorded into a CUDA graph being captured
    counts in `captured` instead."""

    def __init__(self):
        self.launches = 0  # CUDA launches; the plain version is not counted
        self.captured = 0
        self._built = None

    def library(self):
        """Build (or reuse) and load the kernel library; returns the
        utils.cuda_build.BuiltLibrary."""
        if self._built is None:
            from ..utils import cuda_build  # noqa: PLC0415

            built = cuda_build.build_library(_SOURCE)
            fn = built.lib.tailpk_launch
            fn.argtypes = [ctypes.c_void_p] * 9 + [
                ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
            ]
            fn.restype = ctypes.c_int
            self._built = built
        return self._built

    def launch(self, tab, brick, params, f, i, rng, n_steps: int):
        R = f.shape[1]
        dev = f.device
        for name, x, dtype, shape in (
            ("tab", tab, torch.float32, (tab.shape[0], TROW)),
            ("brick", brick, torch.int64, (R,)),
            ("params", params, torch.float32, (N_PARAMS,)),
            ("f", f, torch.float32, (N_F, R)),
            ("i", i, torch.int32, (N_I, R)),
            ("rng", rng, torch.int64, (2, R)),
        ):
            if x.device != dev or x.dtype != dtype or tuple(x.shape) != shape:
                raise ValueError(
                    f"tailpk: {name} must be {dtype} {shape} on {dev}, got "
                    f"{x.dtype} {tuple(x.shape)} on {x.device}"
                )
            if not x.is_contiguous():
                raise ValueError(f"tailpk: {name} must be contiguous")
        fn = self.library().lib.tailpk_launch
        f_out = torch.empty_like(f)
        i_out = torch.empty((2, R), dtype=torch.int32, device=dev)
        rng_out = torch.empty((R,), dtype=torch.int64, device=dev)
        with torch.cuda.device(dev):
            err = fn(
                tab.data_ptr(), brick.data_ptr(), params.data_ptr(),
                f.data_ptr(), i.data_ptr(), rng.data_ptr(),
                f_out.data_ptr(), i_out.data_ptr(), rng_out.data_ptr(),
                R, n_steps, torch.cuda.current_stream(dev).cuda_stream,
            )
        if err != 0:
            raise RuntimeError(f"tailpk launch failed: CUDA error {err}")
        if torch.cuda.is_current_stream_capturing():
            self.captured += 1
        else:
            self.launches += 1
        return f_out, i_out, rng_out


KERNEL = TailKernel()


def run_tail_steps(tab, brick, params, f, i, rng, n_steps: int):
    """n_steps tail steps on R paths (signature of `tail_steps`): the
    plain version for CPU tensors, the CUDA kernel for CUDA tensors."""
    if f.device.type == "cpu":
        return tail_steps(tab, brick, params, f, i, rng, n_steps)
    if f.device.type == "cuda":
        return KERNEL.launch(tab, brick, params, f, i, rng, n_steps)
    raise ValueError(f"tailpk: no kernel for device {f.device}")


def random_tail_state(tables: TailTables, params, n_paths: int, seed: int):
    """Valid kernel inputs for n_paths paths, made with numpy from `seed`:
    origins inside the box, unit directions, box exit and face normal
    from aabb_intersect, brick window and DDA exit as the service loop
    computes them, random bounce counts, ~5% DEAD lanes and random PCG
    streams.  Returns (brick, f, i, rng) on params' device."""
    dev = params.device
    p = params.cpu().numpy()
    rs = np.random.RandomState(seed)
    R = n_paths
    bmin, ext = p[P_BMINX:P_BMINZ + 1], p[P_EXTX:P_EXTZ + 1]
    o_np = (bmin + ext * rs.uniform(0.02, 0.98, (R, 3))).astype(np.float32)
    d_np = rs.normal(size=(R, 3))
    d_np = (d_np / np.linalg.norm(d_np, axis=1, keepdims=True)).astype(
        np.float32
    )
    tput = rs.uniform(0.2, 1.0, (R, 3)).astype(np.float32)
    bounce = rs.randint(0, 8, R)
    status = np.where(rs.uniform(size=R) < 0.05, DEAD, RUN)
    state = rs.randint(0, 1 << 32, R, dtype=np.int64)
    inc = rs.randint(0, 1 << 31, R, dtype=np.int64) * 2 + 1

    def tf(x):
        return torch.tensor(x, dtype=torch.float32, device=dev)

    o, d = tf(o_np), tf(d_np)
    box_min, extent = tf(bmin), tf(ext)
    isect = aabb.aabb_intersect(box_min, box_min + extent, o, d)
    t = torch.zeros(R, dtype=torch.float32, device=dev)
    brick, worg, inv_sig, rho_b, bexit = brick_window(
        o, d, t, box_min, extent, tf(p[P_RM1X:P_RM1Z + 1]), tables.dims,
        tables.major, params[P_SCALE],
    )
    f = torch.stack([
        *o.T, *d.T, *tf(tput).T, t, isect.dist, bexit, inv_sig, rho_b,
        *isect.normal.T,
    ]).contiguous()
    i = torch.cat([
        worg.T.to(torch.int32),
        torch.tensor(np.stack([bounce, status]), dtype=torch.int32, device=dev),
    ]).contiguous()
    rng = torch.tensor(np.stack([state, inc]), dtype=torch.int64, device=dev)
    return brick, f, i, rng
