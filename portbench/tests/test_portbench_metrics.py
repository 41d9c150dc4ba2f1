"""The metrics' arithmetic on a hand-made trace and hand-made calls."""

import json

import pytest

from portbench.lib import device, host, roofline, trace
from portbench.lib.bench import Benchmark
from portbench.run import Call, Run

K1 = "void (anonymous namespace)::encoder_kernel<false>(...)"
K2 = "void (anonymous namespace)::decoder_kernel<false>(...)"
FILL = ("void at::native::vectorized_elementwise_kernel<4, "
        "at::native::FillFunctor<int>>")
COPY = ("void at::native::unrolled_elementwise_kernel<"
        "at::native::direct_copy_kernel_cuda>")
PEAK = {"card": {"hbm_bytes_per_s": 1e9}}


def calls():
    return [Call("compress", 0, 0.010, 1000, 520, 500, 2),
            Call("decompress", 0, 0.004, 520, 1000, 500, 2),
            Call("compress", 1, 0.030, 1000, 520, 500, 2),
            Call("decompress", 1, 0.006, 520, 1000, 500, 2)]


def chrome(tmp_path):
    """Two round trips: compress spans of 10 and 30 ms, decompress spans of
    4 and 6 ms; in each, a fill, the program's kernel and a copy."""
    ev = []

    def x(cat, name, t0_ms, dur_ms):
        ev.append({"ph": "X", "cat": cat, "name": name, "ts": t0_ms * 1e3,
                   "dur": dur_ms * 1e3})

    x("user_annotation", "portbench.compress", 0, 10)
    x("kernel", FILL, 1, 1)
    x("kernel", K1, 2, 6)
    x("gpu_memcpy", "Memcpy DtoH", 8, 1)
    x("kernel", COPY, 9, 0.5)
    x("cpu_op", "aten::copy_", 8, 1.5)
    x("user_annotation", "portbench.decompress", 11, 4)
    x("kernel", K2, 12, 2)
    x("user_annotation", "portbench.compress", 20, 30)
    x("kernel", K1, 21, 20)
    x("kernel", K1, 42, 4)       # a retry: a second launch
    x("user_annotation", "portbench.decompress", 51, 6)
    x("kernel", K2, 52, 3)
    x("gpu_user_annotation", "portbench.compress", 0, 10)
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    return path


def run_of(tmp_path, view=True):
    cs = calls()
    v = trace.TraceView.from_chrome(chrome(tmp_path), cs) if view else None
    return Run(1.5, cs, v, "card", PEAK)


def test_host_clock():
    run = Run(1.5, calls(), None, "card", PEAK)
    assert host.mb_per_s(run, "compress", False) == pytest.approx(
        2000 / 0.040 / 1e6)
    assert host.mb_per_s(run, "decompress", True) == pytest.approx(
        2000 / 0.010 / 1e6)
    assert host.p95_ms(run, "compress") == pytest.approx(
        (0.010 + 0.95 * 0.020) * 1e3)
    assert host.mb_per_s(Run(0, [], None, "", {}), "compress",
                         False) is None


def test_launches(tmp_path):
    run = run_of(tmp_path)
    assert device.launches_per_call(run, "compress") == 1.5
    assert device.launches_per_call(run, "decompress") == 1.0


def test_idle(tmp_path):
    run = run_of(tmp_path)
    # compress: busy 1 + 6 + 1 + 0.5 of 10 ms, 20 + 4 of 30
    assert device.idle_pct(run, "compress") == pytest.approx(
        100 * (1 - 32.5 / 40))
    assert device.idle_pct(run, "decompress") == pytest.approx(
        100 * (1 - 5 / 10))


def test_roofline(tmp_path):
    run = run_of(tmp_path)
    # kernel time: fills counted, copies not: 1 + 6 + 20 + 4 ms
    least = 2 * (1000 + 500 + 52 * 2) / 1e9
    assert roofline.share_pct(run, "compress", roofline.encode_bytes) == \
        pytest.approx(100 * least / 0.031)
    least = 2 * (500 + 1000 + 52 * 2) / 1e9
    assert roofline.share_pct(run, "decompress", roofline.decode_bytes) == \
        pytest.approx(100 * least / 0.005)


def test_nothing_to_read(tmp_path):
    run = run_of(tmp_path, view=False)
    assert device.launches_per_call(run, "compress") is None
    assert device.idle_pct(run, "compress") is None
    assert roofline.share_pct(run, "compress", roofline.encode_bytes) is None
    unknown = Run(1.5, calls(), run_of(tmp_path).view, "other card", PEAK)
    assert roofline.share_pct(unknown, "compress",
                              roofline.encode_bytes) is None


def test_breakdown(tmp_path):
    view = run_of(tmp_path).view
    b = trace.breakdown(view)
    assert b["device_ops"][0] == [K1, pytest.approx(0.030)]
    assert len(b["idle_gaps"]) <= 10
    names = dict(b["idle_gaps"])
    # the compress span's idle stretches: 0-1, 7.0-8.0? no: 7-8 is busy
    # (the copy), 9.5-10, 41-42, 46-50 ms; 8-9.5 is covered
    assert names["compress: python"] == pytest.approx(
        (1 + 0.5 + 1 + 1 + 4) * 1e-3)
    lo, hi = view.window()
    assert (lo, hi) == (0.0, pytest.approx(0.057))


def test_activities_belong_to_the_span_that_issued_them(tmp_path):
    """The card's clock 3 ms behind the host's: each kernel still belongs
    to the span whose runtime call launched it (the shared correlation
    id), and a span's busy time is its own kernels' union."""
    ev = []

    def x(cat, name, t0_ms, dur_ms, corr=None):
        e = {"ph": "X", "cat": cat, "name": name, "ts": t0_ms * 1e3,
             "dur": dur_ms * 1e3}
        if corr is not None:
            e["args"] = {"correlation": corr}
        ev.append(e)

    x("user_annotation", "portbench.compress", 0, 10)
    x("cuda_runtime", "cudaLaunchKernel", 2, 0.01, 7)
    x("kernel", K1, -1, 6, 7)          # issued at 2 ms, stamped at -1
    x("user_annotation", "portbench.decompress", 11, 4)
    x("cuda_runtime", "cudaLaunchKernel", 11.5, 0.01, 8)
    x("kernel", K2, 9.5, 2, 8)         # inside the compress span's time
    path = tmp_path / "drift.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    view = trace.TraceView.from_chrome(path, calls()[:2])
    assert view.tied == (2, 2)
    c, d = view.calls("compress")[0], view.calls("decompress")[0]
    assert [k[1] for k in view.within(c)] == [K1]
    assert [k[1] for k in view.within(d)] == [K2]
    assert view.busy(c) == pytest.approx(0.006)
    assert view.busy(d) == pytest.approx(0.002)


def test_spans_pair_with_calls(tmp_path):
    with pytest.raises(ValueError):
        trace.TraceView.from_chrome(chrome(tmp_path), calls()[:2])


def test_readers_by_name():
    """Every metric of BENCHMARK.json has a reader file that loads."""
    b = Benchmark()
    for m in b.spec["end_to_end"] + b.spec["per_layer"]:
        assert callable(b.reader(m["name"]))
