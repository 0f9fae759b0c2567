"""The port's two probe tools (vampomi_tpu_torch/tools) and the plain versions
of their kernels against the JAX probe scripts on the CPU.

The JAX tools (tools/matvec_floor_probe.py, tools/r4_probe.py) are loaded
by path with importlib and not edited.  Their Pallas kernels run in the
Pallas interpreter: the floor probe's take an `interpret` flag; the r4
probe's do not, so its module's `pl` is swapped, for one test at a time, for
one whose `pallas_call` always interprets.  Inputs are made from a seed with
numpy.  Tolerances:
  * the read-floor sums are integer sums modulo 2^32: bitwise;
  * the matvecs sum exact f32 products in another order: 1e-6 of
    sum |x||v|, with v the vector the kernel multiplies (rounded to bf16 for
    the matrix-unit kernels).
"""

import importlib.util
import json
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vampomi_tpu.ops import pallas_matvec
from vampomi_tpu_torch.ops.atx_int8 import atx_int8_plain
from vampomi_tpu_torch.ops.mxu import (
    atx_mxu, atx_mxu_plain, ax2_packed4_mxu, ax2_packed4_mxu_plain, ax_mxu, ax_mxu_plain,
    bf16_round,
)
from vampomi_tpu_torch.ops.packed4 import atx_packed4_plain
from vampomi_tpu_torch.ops.stream import (
    stream_rowsum, stream_rowsum_plain, stream_sum, stream_sum_plain,
)
from vampomi_tpu_torch.tools import matvec_floor_probe, r4_probe

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parent.parent
TOL = 1e-6


def _load(name):
    spec = importlib.util.spec_from_file_location(f"_jax_tool_{name}", ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jfloor():
    return _load("matvec_floor_probe")


@pytest.fixture(scope="module")
def jr4():
    return _load("r4_probe")


@pytest.fixture
def r4_interpreted(jr4, monkeypatch):
    """The r4 probe with every pallas_call run in the Pallas interpreter."""
    pl = jr4.pl

    class Interpreted:
        def __getattr__(self, name):
            return getattr(pl, name)

        @staticmethod
        def pallas_call(*args, **kwargs):
            return pl.pallas_call(*args, interpret=True, **kwargs)

    monkeypatch.setattr(jr4, "pl", Interpreted())
    return jr4


def _rel(got, want, scale):
    return float(np.max(np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
                        / np.maximum(scale, 1e-30)))


def _bf16(a):
    return bf16_round(torch.from_numpy(np.ascontiguousarray(a))).numpy().astype(np.float64)


def _r4_packed(rng, m, n):
    """Nibbles uniform in [0, 15] (r4_probe.py:216) packed as the r4 probe
    packs them: the low nibble of byte j is sample j, the high nibble sample
    j + N/2; and the (m, N) codes, biased by -8."""
    Xn = rng.integers(0, 16, size=(m, n), dtype=np.int8)
    Xp = (Xn[:, : n // 2] | (Xn[:, n // 2:] << 4)).astype(np.uint8)
    return Xp, Xn.astype(np.float64) - 8


# --------------------------------------------------------------- read floor


@pytest.mark.parametrize("shape", [(512, 256), (1024, 1000)])
@pytest.mark.parametrize("tm", [128, 256])
def test_stream_plain_equals_jax_bitwise(jfloor, shape, tm):
    rng = np.random.default_rng(shape[1] + tm)
    X = rng.integers(-128, 128, size=shape, dtype=np.int8)
    Xt = torch.from_numpy(X)
    want_sum = np.asarray(jfloor.stream_sum(jnp.asarray(X), tm, interpret=True))
    want_rows = np.asarray(jfloor.stream_rowsum(jnp.asarray(X), tm, interpret=True))
    for kern, plain, want in ((stream_sum, stream_sum_plain, want_sum),
                              (stream_rowsum, stream_rowsum_plain, want_rows)):
        got = plain(Xt).numpy()
        assert got.dtype == np.int32 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(kern(Xt).numpy(), want)  # the CPU path is the plain one


def test_stream_sum_sums_every_row_where_jax_drops_the_ragged_tail(jfloor):
    """The TPU grid is M // tm steps: its sum stops at the last whole tile;
    the port's covers all M rows."""
    X = np.random.default_rng(3).integers(-128, 128, size=(1000, 96), dtype=np.int8)
    jax_sum = int(np.asarray(jfloor.stream_sum(jnp.asarray(X), 256, interpret=True))[0, 0])
    assert jax_sum == int(stream_sum_plain(torch.from_numpy(X[:768]))[0, 0])
    assert int(stream_sum_plain(torch.from_numpy(X))[0, 0]) == int(X.astype(np.int64).sum())


def test_stream_sums_wrap_like_int32():
    """Past 2^31 the sums wrap to negative int32, as the TPU kernels' pinned
    int32 accumulators do."""
    X = np.full((2, 17_000_000), 127, dtype=np.int8)
    Xt = torch.from_numpy(X)
    want = np.sum(X, axis=1, dtype=np.int32)
    assert (want < 0).all()
    np.testing.assert_array_equal(stream_rowsum_plain(Xt)[:, 0].numpy(), want)
    assert int(stream_sum_plain(Xt)[0, 0]) == int(np.sum(X, dtype=np.int32))


# -------------------------------------------------------- matrix-unit probes


@pytest.mark.parametrize("shape,tm", [((512, 256), 128), ((256, 1000), 128), ((1024, 512), 256)])
def test_atx_mxu_plain_matches_jax(jfloor, shape, tm):
    m, n = shape
    rng = np.random.default_rng(m + n)
    X = rng.integers(-127, 128, size=shape, dtype=np.int8)
    y = rng.normal(size=n).astype(np.float32)
    want = np.asarray(jfloor.atx_mxu(jnp.asarray(X), jnp.asarray(y), tm, interpret=True))
    got = atx_mxu_plain(torch.from_numpy(X), torch.from_numpy(y)).numpy()
    yb = _bf16(y)
    scale = np.abs(X.astype(np.float64)) @ np.abs(yb)
    assert got.shape == want.shape == (m,)
    assert _rel(got, want, scale) < TOL
    assert _rel(got, X.astype(np.float64) @ yb, scale) < TOL
    np.testing.assert_array_equal(atx_mxu(torch.from_numpy(X), torch.from_numpy(y)).numpy(), got)


@pytest.mark.parametrize("shape,tm", [((512, 256), 128), ((256, 1000), 128), ((1024, 512), 256)])
def test_ax_mxu_plain_matches_jax(jfloor, shape, tm):
    m, n = shape
    rng = np.random.default_rng(m * n)
    X = rng.integers(-127, 128, size=shape, dtype=np.int8)
    w = rng.normal(size=m).astype(np.float32)
    want = np.asarray(jfloor.ax_mxu(jnp.asarray(X), jnp.asarray(w), tm, interpret=True))
    got = ax_mxu_plain(torch.from_numpy(X), torch.from_numpy(w[:, None])).numpy()
    wb = _bf16(w)
    scale = np.abs(X.astype(np.float64)).T @ np.abs(wb)
    assert got.shape == (n, 1) and want.shape == (n,)
    assert _rel(got[:, 0], want, scale) < TOL
    assert _rel(got[:, 0], X.astype(np.float64).T @ wb, scale) < TOL
    np.testing.assert_array_equal(
        ax_mxu(torch.from_numpy(X), torch.from_numpy(w[:, None])).numpy(), got)


@pytest.mark.parametrize("m", [512, 1024])
def test_ax2_packed4_mxu_plain_matches_r4_reference(jr4, m):
    """#12 (ax2_i4_pallas) through its plain version: the r4 probe's own bf16
    einsum reference (r4_probe.py:224-226) and the f64 product with W
    rounded to bf16, on nibbles packed by the probe's own `pack_nibbles`."""
    n = jr4.N
    rng = np.random.default_rng(m)
    Xp, codes = _r4_packed(rng, m, n)
    W2 = rng.normal(size=(m, 2)).astype(np.float32)
    Xn = (codes + 8).astype(np.int8)
    np.testing.assert_array_equal(np.asarray(jr4.pack_nibbles(jnp.asarray(Xn))).view(np.uint8), Xp)
    Xsu = jnp.concatenate([Xn[:, : n // 2], Xn[:, n // 2:]], axis=1) - 8
    ref = np.asarray(jnp.einsum("mk,mn->kn", jnp.asarray(W2).astype(jnp.bfloat16),
                                Xsu.astype(jnp.bfloat16), preferred_element_type=jnp.float32))
    got = ax2_packed4_mxu_plain(torch.from_numpy(Xp), torch.from_numpy(W2)).numpy()
    assert got.shape == (n, 2)
    Wb = _bf16(W2)
    scale = np.abs(codes).T @ np.abs(Wb)
    assert _rel(got, ref.T, scale) < TOL
    assert _rel(got, codes.T @ Wb, scale) < TOL
    np.testing.assert_array_equal(
        ax2_packed4_mxu(torch.from_numpy(Xp), torch.from_numpy(W2)).numpy(), got)


# ------------------------------------- the r4 probe's prototypes (#9, #11)


@pytest.mark.parametrize("m,n,tm", [(1024, 512, 512), (512, 10240, 256)])
def test_r4_prototypes_held_through_the_operator_kernels(m, n, tm):
    """#9 and #11 compute what #1 and #2 compute at the r4 layout (int8 in
    [-127, 127]; nibbles in [0, 15], low = y[:N/2], high = y[N/2:], bias 8):
    the port's plain versions of #1 and #2 against the JAX atx_int8_raw and
    atx_packed4_raw in the Pallas interpreter."""
    rng = np.random.default_rng(n + tm)
    X = rng.integers(-127, 128, size=(m, n), dtype=np.int8)
    Xp, codes = _r4_packed(rng, m, n)
    y = rng.normal(size=n).astype(np.float32)
    y64 = y.astype(np.float64)
    for plain, raw, Xq, C in ((atx_int8_plain, pallas_matvec.atx_int8_raw, X, X.astype(np.float64)),
                              (atx_packed4_plain, pallas_matvec.atx_packed4_raw, Xp, codes)):
        want = np.asarray(raw(jnp.asarray(Xq), jnp.asarray(y), tm, interpret=True))
        got = plain(torch.from_numpy(Xq), torch.from_numpy(y)).numpy()
        scale = np.abs(C) @ np.abs(y64)
        assert _rel(got, want, scale) < TOL
        assert _rel(got, C @ y64, scale) < TOL


def test_r4_vpu_kernels_in_the_interpreter(r4_interpreted):
    """#9 and #11 themselves, the r4 probe's own Pallas kernels at its shapes
    (N = 10,240), in the interpreter, against the port's atx plain versions.
    (#10 and #12 contract bf16 tiles into f32, which the XLA CPU backend
    refuses in the interpreter: #12 is held above through the probe's einsum
    reference.)"""
    jr4 = r4_interpreted
    m, n = 512, jr4.N
    rng = np.random.default_rng(12)
    X = rng.integers(-127, 128, size=(m, n), dtype=np.int8)
    Xp, codes = _r4_packed(rng, m, n)
    y = rng.normal(size=n).astype(np.float32)
    y64, X64 = y.astype(np.float64), X.astype(np.float64)
    got = atx_int8_plain(torch.from_numpy(X), torch.from_numpy(y)).numpy()
    want = np.asarray(jr4.atx_i8_vpu_call(jnp.asarray(X), jnp.asarray(y), 256))
    assert _rel(got, want, np.abs(X64) @ np.abs(y64)) < TOL
    got = atx_packed4_plain(torch.from_numpy(Xp), torch.from_numpy(y)).numpy()
    want = np.asarray(jr4.atx_i4_vpu_call(jnp.asarray(Xp.view(np.int8)), jnp.asarray(y), 256))
    assert _rel(got, want, np.abs(codes) @ np.abs(y64)) < TOL


# ------------------------------------------------------------ entry points

FLOOR_ROWS = {"stream_sum", "stream_rowsum", "atx_int8", "atx_mxu", "atx_int8_plain",
              "ax_batch_int8", "ax_mxu", "ax_batch_int8_plain", "fused_normal_eq"}
R4_ROWS = {"atx_int8", "ax_batch_int8", "atx_packed4", "ax2_packed4_mxu", "ax_batch_packed4"}


@pytest.mark.parametrize("tool,rows,checks", [
    ("matvec_floor_probe", FLOOR_ROWS,
     {"stream_sum", "stream_rowsum", "atx_int8", "atx_mxu", "ax_batch_int8", "ax_mxu"}),
    ("r4_probe", R4_ROWS, {"atx_int8", "atx_packed4", "ax2_packed4_mxu"}),
])
def test_entry_point_small_on_cpu(tool, rows, checks, tmp_path):
    """`python -m vampomi_tpu_torch.tools.<tool> --small --device cpu` runs
    every check and prints a summary with every row, timed on no CPU."""
    argv = [sys.executable, "-m", f"vampomi_tpu_torch.tools.{tool}", "--small", "--device", "cpu"]
    if tool == "matvec_floor_probe":
        argv += ["--out", str(tmp_path / "floor.json")]
    out = subprocess.run(argv, cwd=ROOT, capture_output=True, text=True, timeout=300, check=True)
    line = out.stdout.strip().splitlines()[-1]
    summary = json.loads(line)
    assert summary["tool"] == tool
    assert summary["device"]["platform"] == "cpu"
    assert set(summary["results"]) == rows
    assert all(v == "not measured" for v in summary["results"].values())
    assert set(summary["checks"]) == checks
    for c in summary["checks"].values():
        assert all(v is True if isinstance(v, bool) else v < summary["kernel_tol"]
                   for v in c.values()), c
    assert "paper_peak_gbps" not in summary
    if tool == "matvec_floor_probe":
        assert (tmp_path / "floor.json").read_text().strip() == line
        assert summary["read_floor_gbps"] == "not measured"


@pytest.mark.parametrize("tool", [matvec_floor_probe, r4_probe])
def test_entry_point_cuda_without_a_card_raises(tool, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        tool.main(["--small"])
