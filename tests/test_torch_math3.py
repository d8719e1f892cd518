"""The port's square root (ops/math3.sqrt) and where it is called.

On some hosts torch's CPU float32 sqrt is not correctly rounded: on an
AVX-512 AMD EPYC with torch 2.13.0+cpu, ~15% of uniform inputs come out
1 ulp away from the float64 root rounded to float32, while XLA, numpy and
the card round correctly.  GGX's tan(acos(.)) near grazing grows that ulp
past the JAX-agreement tolerances of tests/test_torch_ops.py and
tests/test_torch_schedulers.py.  math3.sqrt takes CPU float32 through
float64, which is exact; the exactness test below fails on such a host
with plain torch.sqrt in its place.  The source test keeps every square
root of the port on that helper.
"""

import ast
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import cudavolumerenderer_tpu_torch
from cudavolumerenderer_tpu_torch.ops import math3

PACKAGE = Path(cudavolumerenderer_tpu_torch.__file__).resolve().parent


def inputs(n=1 << 17, seed=0):
    """n random positive float32 bit patterns (denormals to the largest
    finite), uniform [0, 1) values, and the edge cases."""
    gen = np.random.default_rng(seed)
    bits = gen.integers(0, 0x7F800000, n // 2, dtype=np.int64).astype(np.uint32)
    edge = np.array([0.0, -0.0, 1e-45, 1e-40, 1.17549435e-38, 1e-38, 1.0,
                     2.0, 3.4e38, 3.4028235e38, np.inf, np.nan, -1.0, -1e-30,
                     -np.inf], np.float32)
    return np.concatenate([bits.view(np.float32),
                           gen.random(n // 2, dtype=np.float32), edge])


def exact_sqrt(x):
    with np.errstate(invalid="ignore"):
        return np.sqrt(x.astype(np.float64)).astype(np.float32)


def test_sqrt_is_correctly_rounded_on_cpu():
    x = inputs()
    assert x.size >= 1 << 16
    got = math3.sqrt(torch.from_numpy(x))
    assert got.dtype == torch.float32
    want = exact_sqrt(x)
    np.testing.assert_array_equal(got.numpy(), want)
    neg = x < 0
    assert np.isnan(got.numpy()[neg]).all()


@pytest.mark.parametrize("dtype", [torch.float64, torch.float16])
def test_sqrt_of_other_types_is_torch_sqrt(dtype):
    x = torch.from_numpy(inputs(1 << 10, seed=1)).abs().to(dtype)
    got = math3.sqrt(x)
    assert got.dtype == dtype
    assert torch.equal(got.nan_to_num(), torch.sqrt(x).nan_to_num())


def test_norm_goes_through_sqrt():
    a = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (4096, 3)).astype(np.float32))
    want = exact_sqrt((a * a).sum(-1).numpy())
    np.testing.assert_array_equal(math3.norm(a).numpy(), want)


# a square root anywhere else: torch.sqrt / rsqrt, the method, ** 0.5,
# pow(0.5) and torch's norms (numpy's float64 ones on the host are exact)
ROOT_CALL = re.compile(
    r"torch\.(r?sqrt|norm|linalg\.norm|linalg\.vector_norm)\(|\.r?sqrt_?\(\)"
    r"|\*\*\s*0?\.5\b|\.pow\(\s*0?\.5\s*\)")


def lines_outside_helper(path):
    """The source lines of `path`, without math3.sqrt's own body."""
    text = path.read_text()
    lines = text.splitlines()
    if path == PACKAGE / "ops" / "math3.py":
        tree = ast.parse(text)
        (fn,) = [n for n in tree.body
                 if isinstance(n, ast.FunctionDef) and n.name == "sqrt"]
        lines = lines[:fn.lineno - 1] + [""] * (fn.end_lineno - fn.lineno + 1) \
            + lines[fn.end_lineno:]
    return lines


def test_no_square_root_outside_math3_sqrt():
    found = []
    files = sorted(PACKAGE.rglob("*.py"))
    assert PACKAGE / "ops" / "ggx.py" in files
    for path in files:
        for no, line in enumerate(lines_outside_helper(path), 1):
            code = line.split("#", 1)[0]
            if ROOT_CALL.search(code):
                found.append(f"{path.relative_to(PACKAGE)}:{no}: {line.strip()}")
    assert not found, "\n".join(found)


def test_source_scan_finds_a_plain_call():
    """The pattern catches each form it is meant to forbid."""
    for code in ("torch.sqrt(x)", "x.sqrt()", "torch.rsqrt(x)", "x.rsqrt()",
                 "x ** 0.5", "x**.5", "x.pow(0.5)", "torch.norm(x)",
                 "torch.linalg.norm(x, dim=-1)"):
        assert ROOT_CALL.search(code), code
    for code in ("math3.sqrt(x)", "math.sqrt(t + 1.0)",
                 "np.linalg.norm(axis)"):
        assert not ROOT_CALL.search(code), code
