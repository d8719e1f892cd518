"""The gather microbenchmark of the port against the JAX script, on the CPU.

(a) each gather kernel's plain version (ops/pgather.py) against numpy,
exactly, and the wrappers' input checks, which run before any kernel;
(b) the port's entry point (cudavolumerenderer_tpu_torch.benchmarks.
micro_pgather, --platform cpu) against JAX's benchmarks/micro_pgather.py
run in process with --interpret, variant by variant: every rep's printed
checksum agrees within 0.011 (its printed precision) and the result keys
agree; (c) the JSON layout.  Both sides make their inputs with numpy from
the same seeds, so they gather the same values.
"""

import importlib.util
import json
import math
import os
import re
import sys

import numpy as np
import pytest
import torch

from cudavolumerenderer_tpu_torch.benchmarks import micro_pgather as port
from cudavolumerenderer_tpu_torch.ops import pgather as pg

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(table_mb=0.25, n=4096, shards=4, inner=2, reps=2)
CHK_TOL = 0.011
REP_LINE = re.compile(r"^\s+(\S+) rep(\d+): .*chk (\S+)$", re.M)
# The JAX script benches xla_packed8 only inside its xla_packed8f branch,
# and xla_packed8f alone fails there; both run as the pair.
JAX_ONLY = {"xla_packed8": "xla_packed8,xla_packed8f",
            "xla_packed8f": "xla_packed8,xla_packed8f"}
# xla_wide skips every table size past the table; 1 MB runs its 1 MB case.
TABLE_MB = {"xla_wide": 1.0}


def argv(**kw):
    size = dict(SMALL, **kw)
    return [a for k, v in size.items()
            for a in (f"--{k.replace('_', '-')}", str(v))]


def run_jax(args, monkeypatch, capsys):
    spec = importlib.util.spec_from_file_location(
        "jax_micro_pgather", os.path.join(ROOT, "benchmarks", "micro_pgather.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(sys, "argv", ["micro_pgather.py", *args])
    capsys.readouterr()
    mod.main()
    return capsys.readouterr().out


def checksums(out, variant):
    """{(name, rep): chk} of the variant's printed rep lines."""
    return {(n, int(r)): float(c) for n, r, c in REP_LINE.findall(out)
            if n == variant or n.startswith(variant + "_")}


def of_variant(results, variant):
    return {k: v for k, v in results.items()
            if k == variant or k.startswith(variant + "_")}


# -- (a) plain versions and wrapper checks ----------------------------------

def numpy_case(name):
    """(wrapper args as numpy, numpy reference) for kernel `name` at the
    small size, on rep 0's indices."""
    V = port.table_rows(SMALL["table_mb"], SMALL["shards"])
    N, S = SMALL["n"], SMALL["shards"]
    args = port.kernel_args(name, torch.from_numpy(port.make_table(V)), N, S)
    np_args = [a.numpy() if isinstance(a, torch.Tensor) else a for a in args]
    tab, idx = np_args[:2]
    ref = {
        "taa1": lambda: np.take_along_axis(tab, idx, axis=1),
        "taa0": lambda: np.take_along_axis(tab, idx, axis=0),
    }.get(name, lambda: np.take(tab, idx))()
    return args, ref


@pytest.mark.parametrize("name", pg.NAMES)
def test_plain_version_matches_numpy(name):
    args, ref = numpy_case(name)
    run, plain = pg.WRAPPERS[name]
    launches = pg.KERNELS[name].launches
    got = plain(*args)
    assert got.dtype == torch.float32 and got.shape == ref.shape
    np.testing.assert_array_equal(got.numpy(), ref)
    # on CPU tensors the wrapper is the plain version and launches nothing
    np.testing.assert_array_equal(run(*args).numpy(), ref)
    assert pg.KERNELS[name].launches == launches


@pytest.mark.parametrize("name", pg.NAMES)
def test_yardstick_equals_plain_version(name):
    """The one torch call timed beside each kernel computes its function."""
    args, ref = numpy_case(name)
    got = pg.YARDSTICKS[name](args[0], args[1].long())
    assert got.dtype == torch.float32 and got.shape == ref.shape
    assert torch.equal(got, pg.WRAPPERS[name][1](*args))


@pytest.mark.parametrize("n, values, value_bytes, want", [
    (262144, None, 4, 3_145_728),  # the published N: idx + values + out
    (262144, 262144, 32, 10_485_760),  # a 32-byte sector per value
    (4096, 1000, 4, 4096 * 8 + 4000),
])
def test_gather_bytes_match_hand_count(n, values, value_bytes, want):
    assert pg.gather_bytes(n, values, value_bytes) == want


@pytest.mark.parametrize("name", pg.NAMES)
def test_touched_counts_distinct_entries_and_sectors(name):
    args, _ = numpy_case(name)
    idx = args[1].numpy().astype(np.int64)
    rows, lanes = np.indices(idx.shape)[0], np.indices(idx.shape)[-1]
    pos = {"taa1": rows * 128 + idx, "taa0": idx * 128 + lanes}.get(name, idx)
    want = (len(np.unique(pos)), len(np.unique(pos // 8)))
    assert pg.touched(name, args[1]) == want
    assert want[1] <= want[0] <= idx.size


def test_stream_mask_leaves_zero_outside_the_table():
    tab = torch.arange(16, dtype=torch.float32) + 1.0
    idx = torch.tensor([[-1, 0, 7, 15, 16, 1 << 30]], dtype=torch.int32)
    got = pg.stream_gather(tab, idx, 4)
    np.testing.assert_array_equal(got.numpy(), [[0, 1, 8, 16, 0, 0]])


@pytest.mark.parametrize("name", pg.NAMES)
def test_wrapper_checks_inputs_before_launching(name):
    """The checks run before the library is touched: on the meta device
    they raise here, without a card."""
    args, _ = numpy_case(name)
    tab, idx, *rest = [a.to("meta") if isinstance(a, torch.Tensor) else a
                       for a in args]
    cpu_tab = args[0]
    run = pg.WRAPPERS[name][0]
    with pytest.raises(ValueError, match="idx must be"):
        run(tab, idx.long(), *rest)
    with pytest.raises(ValueError, match="tab must be"):
        run(tab.double(), idx, *rest)
    with pytest.raises(ValueError, match="contiguous"):
        run(tab, idx.transpose(0, -1).contiguous().transpose(0, -1), *rest)
    with pytest.raises(ValueError, match="on meta"):
        run(cpu_tab, idx, *rest)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        run(tab, idx, *rest)


# -- (b) the entry point against the JAX script -----------------------------

@pytest.mark.parametrize("variant", port.VARIANTS)
def test_entry_point_matches_jax_script(variant, tmp_path, monkeypatch, capsys):
    size = argv(table_mb=TABLE_MB.get(variant, SMALL["table_mb"]))
    jax_json, port_json = tmp_path / "jax.json", tmp_path / "port.json"
    jax_out = run_jax([*size, "--interpret", "--only",
                       JAX_ONLY.get(variant, variant), "--json-out",
                       str(jax_json)], monkeypatch, capsys)
    port.main([*size, "--platform", "cpu", "--only", variant,
               "--json-out", str(port_json)])
    port_out = capsys.readouterr().out

    want, got = checksums(jax_out, variant), checksums(port_out, variant)
    assert want and sorted(got) == sorted(want)
    for key, w in want.items():
        g = got[key]
        assert (math.isnan(w) and math.isnan(g)) or abs(g - w) <= CHK_TOL, (
            key, g, w)
    jax_res = of_variant(json.loads(jax_json.read_text())["results"], variant)
    port_res = json.loads(port_json.read_text())["results"]
    assert sorted(port_res) == sorted(jax_res)
    for res in (*jax_res.values(), *port_res.values()):
        assert "error" not in res
    if variant.startswith("pallas_"):
        assert f"{variant} exact: True" in port_out


@pytest.mark.parametrize("C", [1024, 3000])
def test_bin_positions_match_jax_formulation(C):
    """bin_scatter's positions against the JAX script's csort body
    (benchmarks/micro_pgather.py:248-257), also where C is no power of two
    and some shard ids equal S, as at the published sizes."""
    import jax.numpy as jnp

    S, N = 4, 4096
    shift = int(np.log2(C))
    i = port.fresh_idx(3, N, S * C)
    sid = jnp.asarray(i) >> shift
    oh = sid[:, None] == jnp.arange(S, dtype=jnp.int32)[None, :]
    within = jnp.cumsum(oh.astype(jnp.int32), axis=0) - 1
    counts = within[-1] + 1
    base = jnp.concatenate([jnp.zeros(1, jnp.int32), jnp.cumsum(counts)[:-1]])
    rank = jnp.take_along_axis(within, sid[:, None], axis=1)[:, 0]
    want = np.asarray(jnp.take(base, sid) + rank)
    got = port.bin_positions(torch.from_numpy(i), shift, S)
    assert got.dtype == torch.int32
    assert (int((i >> shift >= S).sum()) > 0) == (C == 3000)
    np.testing.assert_array_equal(got.numpy(), want)


# -- (c) the JSON layout ------------------------------------------------------

def test_json_layout_matches_jax_script(tmp_path, monkeypatch, capsys):
    only = "xla_big,pallas_vmem,pallas_binned"
    jax_json, port_json = tmp_path / "jax.json", tmp_path / "port.json"
    run_jax([*argv(), "--interpret", "--only", only, "--json-out",
             str(jax_json)], monkeypatch, capsys)
    ret = port.main([*argv(), "--platform", "cpu", "--only", only,
                     "--json-out", str(port_json)])
    want, got = json.loads(jax_json.read_text()), json.loads(port_json.read_text())
    assert got == ret
    assert list(got) == list(want) == ["V", "N", "S", "inner", "platform",
                                       "results"]
    assert {k: got[k] for k in ("V", "N", "S", "inner")} == {
        "V": 65536, "N": 4096, "S": 4, "inner": 2}
    assert {k: want[k] for k in ("V", "N", "S", "inner")} == {
        k: got[k] for k in ("V", "N", "S", "inner")}
    assert got["platform"] == want["platform"] == "cpu"
    assert list(got["results"]) == list(want["results"])
    for res in got["results"].values():
        assert sorted(res) == ["mrows_s", "ms_per_gather"]
        assert all(math.isfinite(v) and v > 0 for v in res.values())


def test_cuda_platform_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="--platform cuda"):
        port.main(argv())
