"""The profile reduction on hand-made events: kernels are attributed to the
spans open at their launch, the profiler's device-side copies of host
ranges are not operations, and busy time is the union of operations."""

import pytest

import layertrace


def _cpu(name, start, end, corr=0):
    return dict(name=name, device="cpu", kind="", start=start, end=end, corr=corr)


def _dev(name, start, end, corr, kind="kernel"):
    return dict(name=name, device="cuda", kind=kind, start=start, end=end, corr=corr)


def test_reduce_attributes_kernels_and_idle():
    events = [
        _cpu(layertrace.STRETCH, 0.0, 1000.0),
        _cpu("tracking.track", 10.0, 500.0),
        _cpu("mapping.step", 200.0, 400.0),
        _cpu("cudaLaunchKernel", 20.0, 21.0, corr=1),
        _cpu("cudaLaunchKernel", 250.0, 251.0, corr=2),
        _cpu("cudaLaunchKernel", 600.0, 601.0, corr=3),
        _dev("pose_lm_kernel", 30.0, 130.0, 1),
        _dev("gemm", 260.0, 300.0, 2),
        _dev("Memcpy HtoD", 280.0, 320.0, 3, kind="memcpy"),
        _dev("tracking.track", 10.0, 500.0, 0),  # a mirrored host range
    ]
    p = layertrace.reduce(events)
    assert p.window_s == pytest.approx(1e-3)
    assert p.busy_s == pytest.approx((100.0 + 60.0) * 1e-6)
    assert p.calls("tracking.track") == 1 and p.calls("mapping.step") == 1
    assert p.kernels_in("tracking.track") == 2
    assert p.kernels_in("tracking.track", outside=("mapping.step",)) == 1
    assert p.kernel_times("pose_lm") == [pytest.approx(100e-6)]
    assert [n for n, _ in p.device_ops()] == ["pose_lm_kernel", "gemm", "Memcpy HtoD"]
    # each idle gap is named by the innermost span open when it began
    assert [n for n, _ in p.gaps] == ["mapping.step", "tracking.track", "harness"]
    assert [g for _, g in p.gaps] == pytest.approx([680e-6, 130e-6, 30e-6])


def test_no_stretch_reads_nothing():
    p = layertrace.reduce([_cpu("tracking.track", 0.0, 1.0)])
    assert p.ops == [] and p.window_s == 0.0
