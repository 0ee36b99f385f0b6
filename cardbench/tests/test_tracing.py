"""The trace's readings: a graph launch counts as device time from its
first kernel to its last, whatever the profiler missed between them."""

import pytest

from cardbench import tracing


def _ev(cat, name, ts, dur, corr=None):
    e = {"cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def test_graph_launch_counts_whole():
    events = [
        _ev("user_annotation", tracing.WINDOW, 0.0, 1000.0),
        _ev("user_annotation", "host.step", 420.0, 200.0),
        _ev("cuda_runtime", tracing.GRAPH_LAUNCH, 90.0, 5.0, 7),
        _ev("kernel", "first_trip", 100.0, 10.0, 7),
        _ev("kernel", "tail", 400.0, 20.0, 7),
        _ev("cuda_runtime", "cudaMemcpyAsync", 480.0, 5.0, 9),
        _ev("gpu_memcpy", "Memcpy DtoD", 500.0, 10.0, 9),
        _ev("kernel", "eager", 600.0, 50.0, 8),
    ]
    r = tracing.window_readings(events, ("host.step",))
    assert r["graphs"] == 1
    assert r["busy_s"] == pytest.approx((320.0 + 10.0 + 50.0) * 1e-6)
    assert r["window_s"] == pytest.approx(1000e-6)
    ops = dict(r["breakdown"]["device_ops"])
    assert ops[tracing.GRAPH_OP] == pytest.approx(320e-6)
    assert "first_trip" not in ops and ops["eager"] == pytest.approx(50e-6)
    gaps = r["breakdown"]["idle_gaps"]
    assert gaps[0] == ["other", pytest.approx(350e-6)]
    assert ["host.step", pytest.approx(80e-6)] in gaps


def test_no_device_operation_reads_nothing():
    events = [_ev("user_annotation", tracing.WINDOW, 0.0, 1000.0)]
    assert tracing.window_readings(events, ()) is None
