"""Window arithmetic and the trace's reduction on given numbers: the rate
over the whole window, the 95th percentile over every step, busy and idle
time from intervals, launches and the breakdown."""

from __future__ import annotations

import pytest

from benchmark import window
from benchmark.trace import Trace


def test_rate_is_all_work_over_all_time():
    assert window.rate(640, 2.0) == 320.0
    with pytest.raises(ValueError):
        window.rate(1, 0.0)


def test_step_times_count_every_step_from_the_window_start():
    # the window starts at 0; the third step waited for the host
    assert window.step_times_ms([0.0, 10.0, 20.0, 45.0, 55.0]) == [
        10.0, 10.0, 25.0, 10.0]


def test_p95_over_every_step():
    values = [float(v) for v in range(1, 101)]  # 1 .. 100 ms
    # inclusive method: rank 0.95 x 99 = 94.05 from the first -> 95.05
    assert window.p95(values) == pytest.approx(95.05)
    assert window.p95([10.0] * 99 + [1000.0]) == pytest.approx(10.0)
    # a tenth of the steps stalled: the tail is the stall
    assert window.p95([10.0] * 90 + [1000.0] * 10) == 1000.0
    # a twentieth: between ranks 94 (10) and 95 (1000)
    assert window.p95([10.0] * 95 + [1000.0] * 5) == pytest.approx(59.5)


def test_busy_and_idle_from_intervals():
    iv = [(1.0, 3.0), (2.0, 4.0), (6.0, 7.0), (9.0, 12.0)]
    assert window.union(iv, 0.0, 10.0) == [(1.0, 4.0), (6.0, 7.0),
                                           (9.0, 10.0)]
    assert window.busy(iv, 0.0, 10.0) == 5.0
    assert window.gaps(iv, 0.0, 10.0) == [(0.0, 1.0), (4.0, 6.0),
                                          (7.0, 9.0)]
    assert window.idle_pct(5.0, 10.0) == 50.0


def _ev(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def test_trace_reduction():
    events = [
        _ev("cuda_runtime", "cudaLaunchKernel", 115.0, 5.0),  # before
        _ev("cuda_runtime", "cudaLaunchKernel", 300.0, 5.0),
        _ev("cuda_driver", "cuLaunchKernel", 310.0, 5.0),
        _ev("cuda_runtime", "cudaStreamSynchronize", 560.0, 330.0),
        _ev("cuda_runtime", "cudaLaunchKernel", 2000.0, 5.0),  # after
        _ev("kernel", "sm90_xmma_gemm_bf16", 130.0, 200.0),
        _ev("kernel", "multi_tensor_apply_kernel<Adam>", 400.0, 100.0),
        _ev("gpu_memset", "Memset (Device)", 450.0, 100.0),
        _ev("kernel", "splat_kernel<false>", 900.0, 100.0),
        _ev("kernel", "drc_bwd_kernel", 1300.0, 100.0),
        _ev("gpu_user_annotation", "bench.window", 130.0, 870.0),
    ]
    tr = Trace(events)
    # the window spans the device operations, 130-1400 us; they cover
    # 130-330, 400-550, 900-1000 and 1300-1400
    assert tr.window_s == pytest.approx(1270e-6)
    assert tr.busy_s == pytest.approx(550e-6)
    assert tr.launches == 2
    layers = tr.layers()
    assert layers["GEMMs"] == pytest.approx(200e-6)
    assert layers["Adam (foreach)"] == pytest.approx(100e-6)
    assert layers["renderer forward (K1 / K3)"] == pytest.approx(100e-6)
    b = tr.breakdown()
    assert b["device_ops"][0] == ["sm90_xmma_gemm_bf16", pytest.approx(2e-4)]
    gaps = b["idle_gaps"]
    # 550-900 us: the host was in the sync; 1000-1300 us: outside calls
    assert gaps[0] == ["cudaStreamSynchronize", pytest.approx(350e-6)]
    assert gaps[1] == ["host outside CUDA calls", pytest.approx(300e-6)]
    assert len(gaps) == 3


def test_trace_without_a_device_operation_is_refused():
    with pytest.raises(ValueError):
        Trace([_ev("cuda_runtime", "cudaLaunchKernel", 0.0, 1.0)])
