"""The port's tracer (`utils/metrics.py`): the disabled span is one shared
no-op; enabled spans nest with their parent, frame sequence number and
`time.time_ns()` bounds; the ring drops its oldest records and counts
them; the host-sync hook charges the innermost span and the package's
file:line and ignores syncs made outside the package; a traced RGB-D run
gives the same poses as an untraced one.

The `-m cuda` cases run on the card (torch's sync warnings and a kineto
profile exist only there):
    python -m pytest tests/test_torch_trace.py -q -m cuda --noconftest
"""

import json
import time
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

from orbslam_mapsave_tpu_torch import config as tcfg
from orbslam_mapsave_tpu_torch.io import dataset, synthetic
from orbslam_mapsave_tpu_torch.pipeline import system as tsys
from orbslam_mapsave_tpu_torch.utils import metrics

torch.set_num_threads(2)
PKG = Path(metrics.__file__).resolve().parents[1]
W, H, FX = 320, 240, 200.0


@pytest.fixture()
def tracer():
    metrics.reset()
    metrics.enable()
    try:
        yield metrics.GLOBAL
    finally:
        metrics.disable()
        metrics.reset()


def _by_name(name):
    return [r for r in metrics.GLOBAL.records() if r[1] == name]


def test_off_span_is_the_shared_noop():
    metrics.reset()

    @metrics.traced("off.fn")
    def fn(x):
        return x + 1

    assert metrics.span("off.a") is metrics.NOOP
    assert metrics.span("off.b", frame=True) is metrics.NOOP
    with metrics.span("off.a"):
        assert fn(1) == 2
    metrics.count("off.n", 3)
    s = metrics.summary()
    assert metrics.GLOBAL.n == 0 and metrics.GLOBAL.records() == []
    assert s["spans"] == {} and s["counters"] == {} and s["frames"] == 0


def test_nested_spans_record_parent_frame_and_clock(tracer):
    before = time.time_ns()
    with metrics.span("t.frame", frame=True):
        with metrics.span("t.inner"):
            time.sleep(0.002)
        with metrics.span("t.inner"):
            pass
    after = time.time_ns()
    with metrics.span("t.frame", frame=True):
        pass
    (f0, f1), inner = _by_name("t.frame"), _by_name("t.inner")
    assert len(inner) == 2
    for r in inner:
        assert r[2] == f0[0] and r[3] == 0  # parent, frame sequence number
        assert f0[4] <= r[4] <= r[5] <= f0[5]
    assert before <= f0[4] <= f0[5] <= after
    assert f0[2] == -1 and f0[3] == 0 and f1[3] == 1
    s = metrics.summary()
    frame, inn = s["spans"]["t.frame"], s["spans"]["t.inner"]
    assert frame["calls"] == 2 and inn["calls"] == 2 and s["frames"] == 2
    assert inn["total_ms"] >= 2.0
    assert frame["self_ms"] == pytest.approx(frame["total_ms"] - inn["total_ms"], abs=1e-6)


def test_traced_decorator_and_counters(tracer):
    @metrics.traced("t.fn")
    def fn(x):
        with metrics.span("t.child"):
            return x * 2

    assert fn(3) == 6
    metrics.count("t.n")
    metrics.count("t.n", 4)
    (rec,) = _by_name("t.fn")
    assert _by_name("t.child")[0][2] == rec[0]
    assert metrics.summary()["counters"] == {"t.n": 5}


def test_ring_wraps_and_counts_drops():
    tr = metrics.Tracer(ring=8)
    for i in range(20):
        with tr.span(f"r{i % 3}"):
            pass
    recs = tr.records()
    assert [r[0] for r in recs] == list(range(12, 20))
    assert tr.dropped == 12
    s = tr.summary()
    assert s["dropped"] == 12 and s["records"] == 20
    assert sum(v["calls"] for v in s["spans"].values()) == 20
    with pytest.raises(ValueError):
        metrics.Tracer(ring=12)


def _sync_warning(filename: str, lineno: int):
    """What torch raises at a synchronizing CUDA call under sync debug mode
    "warn", attributed to the frame that made it."""
    warnings.warn_explicit(metrics.SYNC_MESSAGE + " (Triggered internally at "
                           "c10/cuda/CUDAFunctions.cpp:154.)", UserWarning, filename, lineno)


def test_sync_hook_charges_innermost_span_and_site(tracer):
    pkg_file = str(PKG / "pipeline" / "frame.py")
    with metrics.span("t.outer"):
        with metrics.span("t.inner"):
            _sync_warning(pkg_file, 77)
            _sync_warning(pkg_file, 77)
            _sync_warning(__file__, 12)  # the caller's own sync: not the program's
        _sync_warning(str(PKG / "ops" / "orb.py"), 5)
    _sync_warning(pkg_file, 90)  # no span open
    s = metrics.summary()
    assert s["spans"]["t.inner"]["syncs"] == 2 and s["spans"]["t.outer"]["syncs"] == 1
    hs = s["host_syncs"]
    assert hs["total"] == 4
    assert hs["by_site"] == {"orbslam_mapsave_tpu_torch/pipeline/frame.py:77": 2,
                             "orbslam_mapsave_tpu_torch/ops/orb.py:5": 1,
                             "orbslam_mapsave_tpu_torch/pipeline/frame.py:90": 1}
    assert hs["by_span"] == {"t.inner": 2, "t.outer": 1, metrics.OUTSIDE: 1}
    assert _by_name("t.inner")[0][6] == 2


def test_sync_hook_passes_other_warnings_on_and_leaves_on_disable(tracer):
    with pytest.warns(UserWarning, match="unrelated"):
        warnings.warn("unrelated", UserWarning)
    metrics.disable()
    assert warnings.showwarning != metrics.GLOBAL._showwarning
    assert not any(f[1] is not None and f[1].pattern == metrics.SYNC_MESSAGE
                   for f in warnings.filters)
    with pytest.warns(UserWarning, match=metrics.SYNC_MESSAGE):  # shown, not counted
        _sync_warning(str(PKG / "pipeline" / "frame.py"), 77)
    assert metrics.summary()["host_syncs"]["total"] == 0


def test_dump_and_chrome_export(tracer, tmp_path):
    with metrics.span("t.frame", frame=True):
        with metrics.span("t.inner"):
            pass
    metrics.dump(tmp_path / "m.json")
    metrics.export_chrome(tmp_path / "s.json")
    m = json.loads((tmp_path / "m.json").read_text())
    assert set(m) == {"spans", "counters", "host_syncs", "frames", "records", "dropped"}
    ev = json.loads((tmp_path / "s.json").read_text())["traceEvents"]
    assert [e["name"] for e in ev] == ["t.frame", "t.inner"]  # in the order opened
    (inner,) = [e for e in ev if e["name"] == "t.inner"]
    assert inner["ph"] == "X" and inner["ts"] == _by_name("t.inner")[0][4] / 1e3


@pytest.fixture(scope="module")
def tiny_seq(tmp_path_factory):
    out = tmp_path_factory.mktemp("trace_seq")
    K = np.array([[FX, 0, W / 2], [0, FX, H / 2], [0, 0, 1.0]])
    poses = synthetic.orbit_trajectory(5, radius=0.4, yaw_range=0.4)
    synthetic.write_tum_sequence(out, K, poses, width=W, height=H, seed=5,
                                 depth_factor=5000.0)
    return list(dataset.TUMDataset(out, depth_factor=5000.0))


def _tiny_system(device="cpu"):
    cfg = tcfg.SystemConfig()
    cfg.camera = tcfg.CameraConfig(fx=FX, fy=FX, cx=W / 2, cy=H / 2, width=W, height=H,
                                   bf=FX * 0.08, th_depth=50.0, depth_map_factor=5000.0,
                                   fps=30)
    cfg.orb = tcfg.ORBConfig(n_features=600, n_levels=4, scale_factor=1.5)
    cfg.max_keypoints, cfg.max_keyframes, cfg.max_points = 768, 32, 8192
    return tsys.SLAMSystem(cfg, tsys.Sensor.RGBD, enable_loop_closing=False, device=device)


def test_traced_rgbd_run_gives_the_same_poses(tiny_seq):
    slam = _tiny_system()
    untraced = [slam.track_rgbd(g, d, t) for t, g, d in tiny_seq]
    metrics.reset()
    metrics.enable()
    try:
        slam = _tiny_system()
        traced = [slam.track_rgbd(g, d, t) for t, g, d in tiny_seq]
        s = metrics.summary()
    finally:
        metrics.disable()
        metrics.reset()
    for a, b in zip(untraced, traced):
        assert np.array_equal(a, b)
    n = len(tiny_seq)
    assert s["frames"] == n and s["spans"]["system.frame"]["calls"] == n
    assert s["spans"]["build.frame"]["calls"] == n
    assert s["spans"]["orb.extract"]["calls"] == n
    assert s["spans"]["orb.fast_nms"]["calls"] == 4 * n  # one per pyramid level
    assert s["spans"]["track.step"]["calls"] == n


def test_run_slam_trace_dir(tmp_path):
    """`run_slam --trace-dir DIR` traces the run and writes DIR/metrics.json
    (`summary()`) and DIR/spans.json (`export_chrome`) at exit."""
    from orbslam_mapsave_tpu_torch.apps import run_slam

    seq = tmp_path / "seq"
    K = np.array([[FX, 0, W / 2], [0, FX, H / 2], [0, 0, 1.0]])
    synthetic.write_tum_sequence(seq, K, synthetic.orbit_trajectory(3, radius=0.4,
                                                                     yaw_range=0.3),
                                 width=W, height=H, seed=5)
    cam = tmp_path / "cam.yaml"
    cam.write_text("%YAML:1.0\n" + "\n".join(f"{k}: {v}" for k, v in {
        "Camera.fx": FX, "Camera.fy": FX, "Camera.cx": W / 2, "Camera.cy": H / 2,
        "Camera.width": W, "Camera.height": H, "Camera.fps": 30.0, "Camera.bf": FX * 0.08,
        "ThDepth": 50.0, "DepthMapFactor": 5000.0, "ORBextractor.nFeatures": 600}.items()))
    run_slam.main(["--dataset", str(seq), "--camera-yaml", str(cam), "--device", "cpu",
                   "--trace-dir",
                   str(tmp_path / "trace"), "--out", str(tmp_path / "a.txt"),
                   "--kf-out", str(tmp_path / "ak.txt")])
    assert metrics.span("t.after") is metrics.NOOP  # off again
    m = json.loads((tmp_path / "trace" / "metrics.json").read_text())
    assert m["frames"] == 3 and m["spans"]["system.frame"]["calls"] == 3
    ev = json.loads((tmp_path / "trace" / "spans.json").read_text())["traceEvents"]
    assert sum(e["name"] == "system.frame" for e in ev) == 3
    metrics.reset()


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch's sync warnings and device traces)")
    torch.cuda.init()
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_item_counts_one_sync_and_caller_sync_none(card, tracer):
    x = torch.arange(8.0, device=card)
    # package code making one host read: `SLAMSystem.n_keyframes` (int() of
    # a device sum), and an `.item()` compiled as a line of the package
    slam = _tiny_system(device=card)
    pkg_item = compile("v = x.sum().item()", str(PKG / "pipeline" / "system.py"), "exec")
    with metrics.span("t.outer"):
        with metrics.span("t.read"):
            assert slam.n_keyframes == 0
        with metrics.span("t.item"):
            exec(pkg_item, {"x": x})
        with metrics.span("t.harness"):
            torch.cuda.synchronize()
            x.sum().item()  # the caller's own read
    s = metrics.summary()
    assert torch.cuda.get_sync_debug_mode() == 1
    assert s["spans"]["t.read"]["syncs"] == 1
    assert s["spans"]["t.item"]["syncs"] == 1
    assert s["spans"]["t.harness"]["syncs"] == 0
    assert s["host_syncs"]["by_site"]["orbslam_mapsave_tpu_torch/pipeline/system.py:1"] == 1
    metrics.disable()
    assert torch.cuda.get_sync_debug_mode() == 0


@pytest.mark.cuda
def test_span_contains_its_kernel_in_a_kineto_profile(card, tracer):
    x = torch.randn(1024, 1024, device=card)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        with metrics.span("t.matmul"):
            y = x @ x
            torch.cuda.synchronize()
    assert torch.isfinite(y).all()
    (rec,) = _by_name("t.matmul")
    kernels = [(e.start_ns(), e.start_ns() + e.duration_ns())
               for e in prof.profiler.kineto_results.events()
               if "cuda" in str(e.device_type()).lower() and not e.name().startswith("Mem")]
    assert kernels
    assert any(rec[4] <= a <= b <= rec[5] for a, b in kernels), (rec, kernels)
