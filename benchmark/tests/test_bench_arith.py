"""The rate, percentile, idle and roofline arithmetic on synthetic spans and
a synthetic trace with overlapping kernels."""

import pytest

import tiny  # noqa: F401  (paths)
from harness.common import load_module, quantile
from harness.result import judge
from harness.trace import DeviceTrace, label_gaps, reduce_events

METRICS = tiny.BENCH / "metrics"


def _trace():
    # window [10, 11) s; kernels at [10.1, 10.3) and [10.2, 10.4) overlap,
    # a copy at [10.6, 10.7), a kernel past the window's end clipped
    ev = [("decode_step_kernel<int8>", 10.1, 0.2, "kernel"),
          ("gemm", 10.2, 0.2, "kernel"),
          ("Memcpy HtoD", 10.6, 0.1, "gpu_memcpy"),
          ("decode_step_kernel<int8>", 10.95, 0.1, "kernel")]
    return DeviceTrace(10.0, 11.0, ev, True)


def test_busy_union_and_idle():
    tr = _trace()
    flat = [x for iv in tr.busy_intervals() for x in iv]
    assert flat == pytest.approx([10.1, 10.4, 10.6, 10.7, 10.95, 11.0])
    assert tr.busy_s() == pytest.approx(0.45)
    gaps = tr.idle_gaps()
    assert [round(b - a, 6) for a, b in gaps] == [0.1, 0.2, 0.25]
    idle = load_module(METRICS / "device_idle.serve.py", "m_idle")
    assert idle.read({"trace": tr}) == pytest.approx(55.0)
    named = label_gaps(tr, [("fbank", 10.4, 10.6)])
    assert named[0] == ["host: between spans", pytest.approx(0.25)]
    assert ["fbank", pytest.approx(0.2)] in named


def test_reduce_events_aligns_to_the_marker():
    events = [
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 1000.0,
         "dur": 5, "args": {"correlation": 1}},
        {"ph": "X", "cat": "kernel", "name": "spin_kernel(long)", "ts": 1010.0, "dur": 2,
         "args": {"correlation": 1}},
        {"ph": "X", "cat": "kernel", "name": "early", "ts": 900.0, "dur": 2},
        {"ph": "X", "cat": "kernel", "name": "gemm", "ts": 1500.0, "dur": 250},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 1490.0, "dur": 5,
         "args": {"correlation": 2}},
    ]
    tr = reduce_events(events, 50.0, 51.0)
    assert tr.aligned
    assert [(e[0], round(e[1], 6), e[2]) for e in tr.events] == [("gemm", 50.0005, 0.00025)]


def test_quantiles():
    v = [float(i) for i in range(1, 101)]
    assert quantile(v, 0.5) == pytest.approx(50.5)
    assert quantile(v, 0.95) == pytest.approx(95.05)
    assert quantile([], 0.5) is None


def _serve_rec():
    cfg = tiny.serve_config()
    reqs = [{"t0": 0.0, "t1": 1.0 + i, "error": None, "audio_s": 4.0} for i in range(20)]
    calls = [{"t0": 0.0, "t1": 2.0, "timings": {"encoder": 0.2, "text_decode": 1.5},
              "steps": 63, "audio_s": [4.0, 6.0], "ids": [0, 1], "T": 64},
             {"t0": 2.0, "t1": 4.0, "timings": {"encoder": 0.3, "text_decode": 1.5},
              "steps": 127, "audio_s": [10.0], "ids": [2], "T": 128}]
    return {"data": {"requests": reqs, "calls": calls, "config": cfg, "window_s": 4.0,
                     "traced_calls": calls}, "trace": None}


def test_serve_readers():
    rec = _serve_rec()
    rd = {n: load_module(METRICS / f"{n}.py", "m_" + n.replace(".", "_")) for n in (
        "request_p50_ms.serve", "request_p95_ms.serve", "decode_step_ms.serve",
        "encoder_ms_per_audio_s.serve", "mfu.serve", "k1_roofline.serve",
        "launches_per_step.serve")}
    assert rd["request_p50_ms.serve"].read(rec) == pytest.approx(10500.0)
    assert rd["request_p95_ms.serve"].read(rec) == pytest.approx(19050.0)
    assert rd["decode_step_ms.serve"].read(rec) == pytest.approx(1e3 * 3.0 / 190)
    assert rd["encoder_ms_per_audio_s.serve"].read(rec) == pytest.approx(1e3 * 0.5 / 20.0)
    assert 0 < rd["mfu.serve"].read(rec) < 100
    # no trace: the trace's readers find nothing and give nothing
    assert rd["k1_roofline.serve"].read(rec) is None
    assert rd["launches_per_step.serve"].read(rec) is None
    # K1 twice per step of 2 layers in call 0's interval: 1 step, 4 kernels
    rec["trace"] = DeviceTrace(0.0, 4.0, [("decode_step_kernel<x>", 0.5, 1e-3, "kernel"),
                                          ("decode_step_kernel<x>", 0.6, 1e-3, "kernel"),
                                          ("gemm", 0.7, 1e-3, "kernel"),
                                          ("gemm", 0.8, 1e-3, "kernel")], True)
    assert rd["launches_per_step.serve"].read(rec) == pytest.approx(4.0)
    assert 0 < rd["k1_roofline.serve"].read(rec) <= 100


def test_verdict():
    rec = {"failed": 0, "attempted": 3, "checks": {"gap": 1e-6}}
    assert judge(rec, {"limits": {"gap": 1e-3}})[0]
    assert not judge(dict(rec, checks={"gap": 2e-3}), {"limits": {"gap": 1e-3}})[0]
    assert not judge(dict(rec, checks={}), {"limits": {"gap": 1e-3}})[0]
    assert not judge(dict(rec, failed=1), {"limits": {"gap": 1e-3}})[0]
