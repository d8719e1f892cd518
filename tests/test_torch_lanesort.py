"""The lane sort (csrc/lanesort.cu, ops/lanesort.py) on the CPU, which has
no card.

sortingSK's sort point and brickSK's per-round sort run on the card as one
hand-written stable radix sort.  Here: the plain versions against JAX
(`streaming._morton_reorder` on seeded pools with dead lanes, tied keys and
lanes on Morton cell boundaries, every field equal; brickSK's keys through
`to_kernel_keys` and torch.sort against `jnp.argsort`); a numpy model of
the kernel's launches (the keys launch's tile histograms, each pass's
per-warp ranks among equal digits, the warps' and tiles' prefixes and the
digits' scan, the next pass's histograms by the tile a key lands in)
against torch.argsort(stable=True); the wrappers' plain route;
and the layout: the permuted fields and their bytes, the kernel's geometry
and slots against csrc/lanesort.cu, the bound's byte count by hand.  The
kernels against the plain versions, bit for bit, are card tests in
tests/test_torch_cuda.py (`-k sort`).
"""

import re
import types
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from cudavolumerenderer_tpu.models import streaming as jstream
from cudavolumerenderer_tpu.ops.rng import RngState as JRngState
from cudavolumerenderer_tpu_torch.models import streaming
from cudavolumerenderer_tpu_torch.ops import brickbody as bb
from cudavolumerenderer_tpu_torch.ops import familybody as fam
from cudavolumerenderer_tpu_torch.ops import lanesort, morton, stages
from cudavolumerenderer_tpu_torch.ops.rng import RngState

SOURCE = Path(lanesort.__file__).resolve().parents[1] / "csrc" / "lanesort.cu"
BOXES = {"unit": ((-0.5, -0.5, -0.5), (0.5, 0.5, 0.5)),
         "skewed": ((-0.3, -0.7, -0.11), (0.9, 0.2, 0.4))}


# -- seeded pools --------------------------------------------------------------

def pool_arrays(n: int, seed: int, box, dead: float = 0.3,
                boundary: float = 0.3, ties: float = 0.2) -> dict:
    """A StreamState's fields as numpy arrays: positions in and around the
    box, a share of them exactly on a Morton cell's face or an ulp either
    side, a share copied from other lanes (tied keys), a share dead."""
    rng = np.random.default_rng(seed)
    bmin, bmax = (np.asarray(b, np.float32) for b in box)
    ext = bmax - bmin
    o = (bmin + rng.uniform(-0.05, 1.05, (n, 3)).astype(np.float32) * ext)
    on_face = rng.random(n) < boundary
    cells = rng.integers(0, 1025, (n, 3)).astype(np.float32) / np.float32(1024)
    face = (bmin + cells * ext).astype(np.float32)
    nudge = rng.integers(-1, 2, (n, 3))
    face = np.where(nudge < 0, np.nextafter(face, -np.inf),
                    np.where(nudge > 0, np.nextafter(face, np.inf), face))
    o = np.where(on_face[:, None], face, o).astype(np.float32)
    copied = rng.random(n) < ties
    o[copied] = o[rng.integers(0, n, int(copied.sum()))]
    f3 = lambda: rng.normal(size=(n, 3)).astype(np.float32)  # noqa: E731
    return {
        "o": o, "d": f3(), "throughput": f3(), "radiance": f3(),
        "alive": rng.random(n) >= dead, "tracking": rng.random(n) < 0.5,
        "t": rng.random(n).astype(np.float32),
        "max_t": rng.random(n).astype(np.float32), "normal": f3(),
        "image_id": rng.integers(0, 1 << 20, n).astype(np.int32),
        "rng_state": rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(
            np.uint32),
        "rng_inc": (rng.integers(0, 1 << 31, n, dtype=np.uint64) * 2
                    + 1).astype(np.uint32),
        "pending": rng.random(n) < 0.3, "p_scat": f3(),
    }


def torch_pool(a: dict) -> streaming.StreamState:
    t = {k: torch.from_numpy(np.array(v)) for k, v in a.items()}  # copies
    return streaming.StreamState(
        o=t["o"], d=t["d"], throughput=t["throughput"],
        radiance=t["radiance"], alive=t["alive"], tracking=t["tracking"],
        t=t["t"], max_t=t["max_t"], normal=t["normal"],
        image_id=t["image_id"].to(torch.int64),
        rng=RngState(t["rng_state"].to(torch.int64),
                     t["rng_inc"].to(torch.int64)),
        n_rays=torch.tensor(7.0), pending=t["pending"], p_scat=t["p_scat"])


def jax_pool(a: dict):
    j = {k: jnp.asarray(v) for k, v in a.items()}
    return jstream.StreamState(
        o=j["o"], d=j["d"], throughput=j["throughput"],
        radiance=j["radiance"], alive=j["alive"], tracking=j["tracking"],
        t=j["t"], max_t=j["max_t"], normal=j["normal"],
        image_id=j["image_id"],
        rng=JRngState(state=j["rng_state"], inc=j["rng_inc"]),
        n_rays=jnp.float32(7.0), pending=j["pending"], p_scat=j["p_scat"])


def context(box) -> types.SimpleNamespace:
    """What the wrappers read of a FamilyContext: the medium's box."""
    med = types.SimpleNamespace(box_min=torch.tensor(box[0]),
                                box_max=torch.tensor(box[1]))
    return types.SimpleNamespace(scene=types.SimpleNamespace(medium=med))


def field_numpy(s, name: str) -> np.ndarray:
    x = lane_value(s, name)
    return np.asarray(x).astype(np.int64) if name in (
        "rng_state", "rng_inc", "image_id") else np.asarray(x)


def lane_value(s, name: str):
    if name == "rng_state":
        return s.rng.state
    if name == "rng_inc":
        return s.rng.inc
    return getattr(s, name)


# -- parity with JAX -----------------------------------------------------------

@pytest.mark.parametrize("box", sorted(BOXES))
@pytest.mark.parametrize("n,seed,dead", [(1, 0, 0.0), (777, 1, 0.3),
                                         (4096, 2, 0.6), (300, 3, 1.0)])
def test_morton_reorder_matches_jax(n, seed, dead, box):
    """The plain sort point in place (lanesort.morton_reorder_ on CPU
    tensors) and streaming._morton_reorder against JAX's, every field."""
    a = pool_arrays(n, seed, BOXES[box], dead=dead)
    want = jstream._morton_reorder(jax_pool(a), jnp.asarray(BOXES[box][0],
                                                            jnp.float32),
                                   jnp.asarray(BOXES[box][1], jnp.float32))
    pool = torch_pool(a)
    keep = {n_: lane_value(pool, n_).data_ptr() for n_ in fam.LANE_FIELDS}
    ctx = context(BOXES[box])
    lanesort.morton_reorder_(ctx, pool)
    med = ctx.scene.medium
    other = streaming._morton_reorder(torch_pool(a), med.box_min, med.box_max)
    for name in fam.LANE_FIELDS:
        w = field_numpy(want, name)
        np.testing.assert_array_equal(field_numpy(pool, name), w, name)
        np.testing.assert_array_equal(field_numpy(other, name), w, name)
        assert lane_value(pool, name).data_ptr() == keep[name]
    assert float(pool.n_rays) == 7.0


def test_morton_keys_on_cell_faces():
    """The pools above reach every case the kernel's keys must meet: lanes
    on a cell's face and an ulp either side land in different cells, keys
    tie, and dead lanes sort last in lane order."""
    a = pool_arrays(4096, 5, BOXES["skewed"])
    box = [torch.tensor(b) for b in BOXES["skewed"]]
    keys = morton.ray_sort_keys(torch.from_numpy(a["o"]), *box,
                                torch.from_numpy(a["alive"]))
    live = keys[torch.from_numpy(a["alive"])]
    assert int(live.max()) < lanesort.DEAD
    assert live.unique().numel() < live.numel()
    p01 = (torch.from_numpy(a["o"]) - box[0]) / (box[1] - box[0])
    q = p01 * 1024.0
    assert bool((q == torch.floor(q)).any())  # exactly on a face
    order = torch.argsort(keys, stable=True)
    dead = torch.nonzero(~torch.from_numpy(a["alive"])).reshape(-1)
    assert torch.equal(order[-dead.numel():], dead)


@pytest.mark.parametrize("n,seed", [(128, 0), (160000 // 40, 1)])
def test_brick_order_matches_jax(n, seed):
    """brickSK's keys (the eager loop's int64, sentinel 0xFFFFFFFF) through
    to_kernel_keys and torch.sort (the plain version) against
    jnp.argsort of JAX's uint32 keys: the same order and sorted keys."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 37, n).astype(np.int64)
    keys[rng.random(n) < 0.4] = 0xFFFFFFFF
    order = np.asarray(jnp.argsort(jnp.asarray(keys.astype(np.uint32))))
    kk = bb.to_kernel_keys(torch.from_numpy(keys))
    skeys, got = torch.sort(kk, stable=True)
    np.testing.assert_array_equal(got.numpy(), order)
    np.testing.assert_array_equal(
        skeys.numpy(), np.where(keys[order] == 0xFFFFFFFF, bb.SENTINEL,
                                keys[order]))
    mk, morder = model_sort(mapped_brick_keys(kk.numpy(), 37), 37)
    np.testing.assert_array_equal(morder, order)


# -- a model of the kernel's launches --------------------------------------------

def model_sort(keys: np.ndarray, top: int, threads: int = lanesort.THREADS,
               items: int = lanesort.ITEMS,
               radix_bits: int = lanesort.RADIX_BITS):
    """csrc/lanesort.cu's launches in numpy on uint32 keys of at most `top`:
    (sorted keys, order).  The keys launch's per-tile histograms of the
    first digit; each pass a block per tile, its warps' keys in position
    order ranked among equal digits (the peers before a lane in its round
    of 32, plus its warp's running count), the warps' exclusive prefixes,
    the earlier tiles' counts and the digits' exclusive scan from the
    pass's histograms, and each placed key counted in the next pass's
    histogram of the tile it lands in."""
    n = len(keys)
    radix, warps = 1 << radix_bits, threads // 32
    tile = threads * items
    tiles = -(-n // tile)
    passes = max(1, -(-int(top).bit_length() // radix_bits))
    kin = np.asarray(keys, np.int64)
    iin = np.arange(n)
    counts = np.zeros((passes, tiles, radix), np.int64)
    for b in range(tiles):
        counts[0, b] = np.bincount(kin[b * tile:(b + 1) * tile] & (radix - 1),
                                   minlength=radix)
    for p in range(passes):
        shift = p * radix_bits
        digit = (kin >> shift) & (radix - 1)
        kout, iout = np.empty_like(kin), np.empty_like(iin)
        filled = np.zeros(n, bool)
        for b in range(tiles):
            run = np.zeros((warps, radix), np.int64)
            placed = []
            for w in range(warps):
                for j in range(items):
                    lo = b * tile + w * 32 * items + j * 32
                    idx = np.arange(lo, min(lo + 32, n))
                    for lane, i in enumerate(idx):
                        d = digit[i]
                        peers_before = int(np.count_nonzero(
                            digit[idx[:lane]] == d))
                        placed.append((i, w, d, run[w, d] + peers_before))
                    np.add.at(run[w], digit[idx], 1)
            warp_prefix = np.cumsum(run, axis=0) - run
            total = counts[p].sum(axis=0)
            base = np.cumsum(total) - total + counts[p, :b].sum(axis=0)
            for i, w, d, rank in placed:
                dest = base[d] + warp_prefix[w, d] + rank
                assert not filled[dest]
                filled[dest] = True
                kout[dest], iout[dest] = kin[i], iin[i]
                if p + 1 < passes:
                    nxt = (kin[i] >> (shift + radix_bits)) & (radix - 1)
                    counts[p + 1, dest // tile, nxt] += 1
        assert filled.all()
        kin, iin = kout, iout
    return kin, iin


def mapped_brick_keys(keys: np.ndarray, n_bricks: int) -> np.ndarray:
    """The brick keys launch's keys: SENTINEL as n_bricks."""
    return np.where(keys == lanesort.SENTINEL, n_bricks, keys).astype(
        np.int64)


def morton_case(n, seed, dead=0.2):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 1 << 30, n)
    keys[rng.random(n) < dead] = lanesort.DEAD
    return keys, lanesort.DEAD


def brick_case(n, seed, n_bricks):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, n_bricks, n)
    keys[rng.random(n) < 0.3] = lanesort.SENTINEL
    return keys, n_bricks


MODEL_CASES = {
    "n1": lambda: morton_case(1, 0),
    "ragged": lambda: morton_case(lanesort.TILE + 953, 1),
    "n4096": lambda: morton_case(1 << 12, 2),
    "all_dead": lambda: morton_case(2500, 3, dead=1.0),
    "all_equal": lambda: (np.full(4096, 12345), lanesort.DEAD),
    "codes30": lambda: morton_case(5000, 4, dead=0.0),
    "ties": lambda: (np.random.default_rng(5).integers(0, 16, 4096) << 26,
                     lanesort.DEAD),
    "brick1": lambda: brick_case(3000, 6, 1),
    "brick7": lambda: brick_case(3000, 7, 7),
    "brick255": lambda: brick_case(4100, 8, 255),
    "brick256": lambda: brick_case(4100, 9, 256),
    "brick4096": lambda: brick_case(4096, 10, 4096),
}


@pytest.mark.parametrize("geometry", ["kernel", "small"])
@pytest.mark.parametrize("case", sorted(MODEL_CASES))
def test_model_matches_stable_argsort(case, geometry):
    """The model of the kernel's launches gives torch.argsort(stable=True)'s
    order and the sorted keys (brick cases: the sentinel mapped to n_bricks
    and back), at the kernel's geometry and at tiles of 128 keys (2 warps,
    2 keys a lane: many tiles on a few thousand keys)."""
    keys, top = MODEL_CASES[case]()
    brick_mode = case.startswith("brick")
    keyed = mapped_brick_keys(keys, top) if brick_mode else keys
    geo = {} if geometry == "kernel" else {"threads": 64, "items": 2}
    skeys, order = model_sort(keyed, top, **geo)
    want = torch.argsort(torch.from_numpy(np.asarray(keys, np.int64)),
                         stable=True).numpy()
    np.testing.assert_array_equal(order, want)
    if brick_mode:
        skeys = np.where(skeys == top, lanesort.SENTINEL, skeys)
        ws, wo = torch.sort(torch.from_numpy(np.asarray(keys, np.int32)),
                            stable=True)
        np.testing.assert_array_equal(skeys, ws.numpy())
        np.testing.assert_array_equal(order, wo.numpy())
    else:
        np.testing.assert_array_equal(skeys, np.asarray(keys)[want])


@settings(max_examples=25, deadline=None)
@given(n=st.integers(1, 700), bits=st.integers(1, 31),
       threads=st.sampled_from([32, 64]), items=st.integers(1, 3),
       seed=st.integers(0, 2**31 - 1))
def test_model_random_keys(n, bits, threads, items, seed):
    """The model at random small geometries against the stable argsort on
    keys of `bits` bits, with many ties when bits is small."""
    keys = np.random.default_rng(seed).integers(0, 1 << bits, n)
    skeys, order = model_sort(keys, (1 << bits) - 1, threads, items)
    want = torch.argsort(torch.from_numpy(keys), stable=True).numpy()
    np.testing.assert_array_equal(order, want)
    np.testing.assert_array_equal(skeys, keys[want])


def test_passes_for():
    """31 bits of Morton keys in 4 passes; brick keys up to n_bricks."""
    assert lanesort.passes_for(lanesort.DEAD) == 4
    assert lanesort.passes_for(lanesort.SENTINEL) == 4
    assert [lanesort.passes_for(b) for b in (1, 255, 256, 65535, 65536)] == [
        1, 1, 2, 2, 3]


# -- the wrappers' plain route ----------------------------------------------------

def test_plain_route_on_cpu_and_no_gate_there():
    """On CPU tensors the wrappers run the plain versions in place (the
    pool's tensors kept); the gate reads the card's control words, so a
    gated sort of CPU tensors is refused."""
    a = pool_arrays(500, 11, BOXES["unit"])
    ctx = context(BOXES["unit"])
    pool = torch_pool(a)
    keep = [lane_value(pool, n).data_ptr() for n in fam.LANE_FIELDS]
    lanesort.morton_reorder_(ctx, pool)
    want = streaming._morton_reorder(torch_pool(a), ctx.scene.medium.box_min,
                                     ctx.scene.medium.box_max)
    for name in fam.LANE_FIELDS:
        np.testing.assert_array_equal(field_numpy(pool, name),
                                      field_numpy(want, name))
    assert keep == [lane_value(pool, n).data_ptr() for n in fam.LANE_FIELDS]
    ctrl = torch.zeros(stages.N_CTRL + 1, dtype=torch.int64)
    with pytest.raises(ValueError, match="runs on the card"):
        lanesort.morton_reorder_(ctx, pool, ctrl, 8)
    bufs = bb.RoundBuffers.make(300, "cpu")
    bufs.keys.copy_(torch.from_numpy(brick_case(300, 12, 9)[0].astype(
        np.int32)))
    with pytest.raises(ValueError, match="runs on the card"):
        bufs.sort(ctrl[:stages.N_CTRL], n_bricks=9)
    bufs.sort(n_bricks=9)
    ws, wo = torch.sort(bufs.keys, stable=True)
    assert torch.equal(bufs.skeys, ws) and torch.equal(bufs.order, wo)


def test_wrappers_refuse_other_devices():
    """A tensor on neither the CPU nor the card has no route."""
    pool = torch_pool(pool_arrays(4, 13, BOXES["unit"]))
    meta = stages.own(pool)
    meta = type(pool)(*(v.to("meta") if isinstance(v, torch.Tensor)
                        else type(v)(*(x.to("meta") for x in v))
                        for v in meta))
    with pytest.raises(ValueError, match="no kernel"):
        lanesort.morton_reorder_(context(BOXES["unit"]), meta)
    with pytest.raises(ValueError, match="no kernel"):
        lanesort.brick_sort_(bb.RoundBuffers.make(128, "meta"))


# -- the layout ------------------------------------------------------------------

def cu_int(name: str) -> int:
    m = re.search(rf"constexpr (?:int|uint32_t) {name} = ([^;]+);",
                  SOURCE.read_text())
    return int(eval(m.group(1).replace("u", "")))  # noqa: S307


def test_geometry_and_constants_match_source():
    """The wrapper's geometry, sentinel and dead key are the kernel's, and
    brickbody's sentinel is the sort's."""
    assert cu_int("THREADS") == lanesort.THREADS
    assert cu_int("ITEMS") == lanesort.ITEMS
    assert cu_int("RADIX_BITS") == lanesort.RADIX_BITS
    assert cu_int("MAX_PASSES") == lanesort.MAX_PASSES
    assert cu_int("SENTINEL") == lanesort.SENTINEL == bb.SENTINEL
    assert cu_int("DEAD") == lanesort.DEAD
    assert lanesort.DEAD > (1 << 30) - 1  # after every 30-bit code
    assert morton.DEAD_KEY > lanesort.DEAD


def test_slots_match_source():
    """The pointer slots in the kernel's enum order."""
    text = SOURCE.read_text()
    body = re.search(r"enum \{\s*S_FIELD = 0,(.*?)N_S,\s*\};", text,
                     re.S).group(1)
    names = [item.split("=")[0].strip() for item in body.split(",")
             if item.strip()]
    assert names[:2] == ["S_SCRATCH", "S_KA"]
    assert re.search(r"S_SCRATCH = S_FIELD \+ N_LANE", body)
    assert re.search(r"S_KA = S_SCRATCH \+ N_LANE", body)
    assert [getattr(lanesort, x) for x in names[1:]] == list(
        range(lanesort.S_KA, lanesort.N_S))
    assert cu_int("N_LANE") == lanesort.N_LANE


def test_permuted_fields_cover_the_pool():
    """The permute's field table is every familybody.LANE_FIELDS name with
    its FIELD_BYTES, in the kernel's order, and a StreamState's fields are
    those bytes a lane."""
    text = SOURCE.read_text()
    cu = re.search(r"FIELD_BYTES\[N_LANE\] = \{([^}]*)\}", text).group(1)
    assert tuple(int(x) for x in cu.split(",")) == lanesort.FIELD_BYTES
    assert lanesort.FIELDS == fam.LANE_FIELDS
    assert dict(zip(lanesort.FIELDS, lanesort.FIELD_BYTES)) == \
        fam.FIELD_BYTES
    pool = torch_pool(pool_arrays(3, 14, BOXES["unit"]))
    for name, nb in zip(lanesort.FIELDS, lanesort.FIELD_BYTES):
        x = lane_value(pool, name)
        assert x[0].numel() * x.element_size() == nb, name
    assert sum(lanesort.FIELD_BYTES) == 107


def test_sort_bytes_by_hand():
    """The bound on a tiny pool: 5 lanes of 107 B read and written; 5 brick
    keys (4 B), skeys (4 B), order (8 B); and the passes' own traffic."""
    assert lanesort.sort_bytes(5, "morton") == 5 * (107 + 107)
    assert lanesort.sort_bytes(5, "brick") == 5 * (4 + 4 + 8)
    assert lanesort.sort_bytes(5, "morton", passes=4) == 5 * (
        214 + 4 + 4 * 16)
    assert lanesort.sort_bytes(5, "brick", passes=2) == 5 * (16 + 4 + 2 * 16)
    with pytest.raises(ValueError):
        lanesort.sort_bytes(5, "other")


def test_round_buffers_sort_on_cpu_is_torch_sort():
    """RoundBuffers.sort on CPU tensors is torch.sort(stable=True), with
    or without n_bricks, as the eager loop sorts."""
    rng = np.random.default_rng(15)
    for n_bricks in (None, 40):
        bufs = bb.RoundBuffers.make(1000, "cpu")
        keys = rng.integers(0, 40, 1000)
        keys[rng.random(1000) < 0.5] = bb.SENTINEL
        bufs.keys.copy_(torch.from_numpy(keys.astype(np.int32)))
        bufs.sort(n_bricks=n_bricks)
        ws, wo = torch.sort(bufs.keys, stable=True)
        assert torch.equal(bufs.skeys, ws) and torch.equal(bufs.order, wo)
