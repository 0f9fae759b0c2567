"""The benchmark's arithmetic on the CPU: the roofline's byte counts, the
passes over the design counted from a trace per solver, the card's busy
time as the union of overlapping streams, the idle gaps by host operation,
and the per-layer readers on hand-made runs."""

import json
from types import SimpleNamespace

import pytest

from benchmark import roofline, spec, trace
from benchmark.cell import Run

NS_M, NS_N, I4_M = 1_048_576, 10_240, 2_097_152


def test_design_bytes_and_pass_bound():
    assert roofline.design_bytes(NS_M, NS_N, packed=False) == NS_M * NS_N       # 10 GiB int8
    assert roofline.design_bytes(I4_M, NS_N, packed=True) == I4_M * NS_N // 2   # 10 GiB packed
    assert roofline.design_bytes(NS_M, NS_N, False) == 10 * 2**30
    # the bytes bind a pass at K <= 2: 10 GiB at 3.35 TB/s
    t, by = roofline.bound_s(10 * 2**30, 2 * NS_M * NS_N * 2)
    assert by == "bytes" and t == pytest.approx(10 * 2**30 / 3.35e12)
    assert t == pytest.approx(3.205e-3, rel=1e-3)
    assert roofline.bound_s(roofline.design_bytes(I4_M, NS_N, True), 2 * I4_M * NS_N * 2)[0] == t
    # operations bind where they outrun the bytes
    assert roofline.bound_s(1, 67e12) == (1.0, "operations")


def _kernel(name, ts, dur, stream=7):
    return {"ph": "X", "cat": "kernel", "name": name, "ts": ts, "dur": dur, "tid": stream}


def _host(name, ts, dur):
    return {"ph": "X", "cat": "cpu_op", "name": name, "ts": ts, "dur": dur, "tid": 1}


ATX = "void atx_int8_kernel<true, true>(signed char const*, float const*, float*, long long, long long)"
XTW = "void vampomi::xtw_kernel<vampomi::ByteCodes<1>, 2, 16, true>(unsigned char const*, ...)"
XTW4 = "void vampomi::xtw_kernel<vampomi::ByteCodes<2>, 2, 16, true>(unsigned char const*, ...)"
XY = "void vampomi::xy_kernel<vampomi::ByteCodes<1>, 2, 4, true, true>(unsigned char const*, ...)"
XY4 = "void vampomi::xy_kernel<vampomi::ByteCodes<2>, 1, 4, true, true>(unsigned char const*, ...)"
SUM = "void vampomi::sum_splits_kernel(float const*, float*, long long, long long)"
GEMM = "sm90_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize128x128x32_warpgroupsize1x1x1"


def _fit_trace(kernels, iters, steps=0):
    """A fit's kernels one after another, 1 us apart: A^T y, then per
    iteration (exact) an X^T W pass with its split sum and an A^T pass,
    or (CG) 4 X^T W passes, 1 A^T Y pass and `steps` of each more."""
    atx, xtw, xy = kernels
    names = [atx]
    for _ in range(iters):
        if steps:
            names += [xtw, SUM] * (4 + steps) + [xy] * (1 + steps) + [atx]
        else:
            names += [xtw, SUM, GEMM, atx]
    return [_kernel(n, 10 * i, 9) for i, n in enumerate(names)]


@pytest.mark.parametrize("design", ["int8", "int4"])
@pytest.mark.parametrize("solver", ["exact", "cg"])
def test_passes_per_solver(design, solver):
    kernels = (ATX, XTW, XY) if design == "int8" else (XY4, XTW4, XY4)
    iters, steps = 50, (9 if solver == "cg" else 0)
    passes, secs = trace.xpass_launches(_fit_trace(kernels, iters, steps), spec.xpass_kernels())
    # exact: 1 (A^T y) + 2 an iteration; CG: A^T y, and an iteration's
    # x1, x2, probe and residual passes, its trace pass, 2 a step, A^T q
    want = 1 + iters * 2 if solver == "exact" else 1 + iters * (4 + steps + 1 + steps + 1)
    assert passes == want
    # the split sums are timed with their pass, the GEMMs are not
    kern = want + iters * (4 + steps if steps else 1)
    assert secs == pytest.approx(kern * 9e-6)


def test_every_pattern_file_names_its_passes():
    for k in spec.xpass_kernels():
        assert set(k) == {"kernel", "match", "x_reads"} and k["match"] and k["x_reads"] in (0, 1)
    assert not any(trace.matches(GEMM, k) for k in spec.xpass_kernels())
    for name in (ATX, XTW, XTW4, XY, XY4, SUM):
        assert sum(trace.matches(name, k) for k in spec.xpass_kernels()) == 1


def test_busy_is_the_union_of_overlapping_streams():
    events = [
        _kernel("a", 0, 10, stream=7), _kernel("b", 5, 10, stream=8),   # overlap: 0-15
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 20, "dur": 5},
        {"ph": "X", "cat": "gpu_memset", "name": "Memset", "ts": 24, "dur": 2},  # 20-26
        _kernel("c", 40, 10),                                            # 40-50
        {"ph": "X", "cat": "gpu_user_annotation", "name": "fit", "ts": 0, "dur": 100},
        _host("aten::mm", 0, 100),
    ]
    busy, window = trace.busy_and_window_s(events)
    assert busy == pytest.approx(31e-6) and window == pytest.approx(100e-6)
    gaps = dict(trace.idle_gaps(events + [_host("aten::item", 27, 12)]))
    # 15-20 under aten::mm; 26-40 under aten::item (27-39) at its middle 33;
    # 50-100 under aten::mm
    assert gaps == pytest.approx({"aten::mm": 55e-6, "aten::item": 14e-6})
    top = trace.top_device_ops(events)
    assert top[0][0] in ("a", "b", "c") and top[0][1] == pytest.approx(10e-6)
    assert len(top) == 5


def _fit(iter_seconds, setup):
    return SimpleNamespace(result=SimpleNamespace(iter_seconds=iter_seconds, setup=setup))


def test_readers_on_a_hand_made_run():
    fits = [_fit([9.0, 0.020, 0.030, 0.025], {"aty": 0.1, "gram": 4.0, "eigh": 1.5}),
            _fit([9.0, 0.010], {"aty": 0.1, "gram": 4.2, "eigh": 1.3})]
    events = _fit_trace((ATX, XTW, XY), 3)
    run = Run(fits=fits, events=events, kernels=spec.xpass_kernels(), x_bytes=10 * 2**30,
              busy_s=2.0, window_s=8.0)
    assert spec.reader("iter_ms")(run) == pytest.approx(22.5)
    assert spec.reader("factor_s")(run) == pytest.approx(5.5)
    assert spec.reader("device_idle")(run) == pytest.approx(75.0)
    # 7 passes of 10 GiB at 3.35 TB/s in 10 kernels of 9 us each
    share = spec.reader("xpass_roofline")(run)
    assert share == pytest.approx(100 * 7 * 10 * 2**30 / 3.35e12 / 90e-6)
    # nothing to read: no factor under CG, no trace, no pass kernels
    cg = Run(fits=[_fit([1.0, 0.09], {"aty": 0.1})], events=None, kernels=[], x_bytes=1,
             busy_s=None, window_s=None)
    for name in ("factor_s", "xpass_roofline", "device_idle"):
        assert spec.reader(name)(cg) is None
    assert spec.reader("xpass_roofline")(run._replace(events=[_kernel(GEMM, 0, 5)])) is None


def test_benchmark_json_names_a_reader_for_every_per_layer_metric():
    with open(spec.ROOT / "BENCHMARK.json") as f:
        bench = json.load(f)
    for m in bench["per_layer"]:
        assert callable(spec.reader(m["name"]))
    for w in bench["workloads"]:
        c = spec.cell(w["name"])
        assert c.traffic["lmmse_solver"] in ("auto", "eigen", "cg")
        assert 1 <= c.limits["head_iterations"] <= c.config["iterations"]
        assert c.limits["sample"] >= 1 and c.limits["limits"]
