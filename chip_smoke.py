"""Smoke test of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each raises on failure; the script then exits non-zero and prints
no result):

1. device   — a CUDA card must be present; prints its name and power limit.
2. build    — compiles the pose-LM kernel (csrc/pose_lm.cu) with nvcc.
3. kernel   — the kernel against its plain PyTorch version on the card at
              M = 2048, 900, 1024 edges and B = 1, 4 problems: pose max-abs
              <= 1e-4, identical inlier sets, two runs bit-identical; then
              both timed with CUDA events (median of 50).
4. slice    — the benchmark sequence (bench.py: 640x480, 2000 ORB features,
              circle_trajectory(240, radius=0.55, revs=1.30) in a
              BoxRoom(2.0, seed=11), u8 image + f16 depth) through
              SLAMSystem RGB-D tracking at max_keypoints=2048,
              max_keyframes=64, max_points=32768: no frame lost, keyframe
              count within 20% of the JAX package's CPU run, keyframe ATE
              within 1 cm of it, and >= 2 pose-LM launches per tracked
              frame.

The last lines are a JSON record of the kernels, the card's
`nvidia-smi` name/power line, and {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

# JAX package, CPU, same sequence and configuration with enable_mapping=False
# and no vocabulary (measured once; see PERF.md): 240 frames, none lost.
JAX_CPU_KEYFRAMES = 23
JAX_CPU_KF_ATE_M = 0.023118204057347373
N_FRAMES = 240
W, H = 640, 480
POSE_TOL = 1e-4  # kernel vs plain: f32 sums in another order


def log(*a):
    print(*a, flush=True)


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this smoke test runs on the card only")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    log(f"[device] {torch.cuda.get_device_name(0)} | torch {torch.__version__} "
        f"cuda {torch.version.cuda} | {smi}")
    return smi


def phase_build():
    from orbslam_mapsave_tpu_torch.optim import pose_opt_cuda

    t0 = time.perf_counter()
    path = pose_opt_cuda.build()
    log(f"[build] {path.name} in {time.perf_counter() - t0:.2f} s")


def _time_ms(fn, n=50) -> float:
    for _ in range(3):
        fn()
    times = []
    for _ in range(n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def phase_kernel(dev) -> dict:
    from orbslam_mapsave_tpu_torch.optim import pose_opt, pose_opt_cuda
    from orbslam_mapsave_tpu_torch.optim.pose_problem import (CAM, batch_obs,
                                                              make_problem)

    worst = 0.0
    for M in (2048, 900, 1024):
        for B in (1, 4):
            probs = [make_problem(M, seed=7 + b) for b in range(B)]
            obs = batch_obs(probs, dev)
            pose0 = torch.eye(4, device=dev).expand(B, 4, 4).contiguous()
            p1, i1, n1 = pose_opt_cuda.pose_optimization_cuda(CAM, pose0, obs)
            p2, i2, _ = pose_opt_cuda.pose_optimization_cuda(CAM, pose0, obs)
            torch.cuda.synchronize()
            if not (torch.equal(p1, p2) and torch.equal(i1, i2)):
                raise AssertionError(f"kernel not bit-repeatable at M={M} B={B}")
            for b in range(B):
                pr, ir, nr = pose_opt.pose_optimization_ref(
                    CAM, pose0[b], pose_opt.PoseObs(*[x[b] for x in obs]))
                err = (p1[b] - pr).abs().max().item()
                worst = max(worst, err)
                if not (err <= POSE_TOL and torch.equal(i1[b], ir)
                        and int(n1[b]) == int(nr)):
                    raise AssertionError(
                        f"kernel != plain at M={M} B={B} b={b}: pose err {err:.3g}, "
                        f"inliers {int(n1[b])} vs {int(nr)}")
            log(f"[kernel] M={M} B={B}: ok (inliers {n1.tolist()})")
    # timing at the main path's shape: one problem of M = max_keypoints.
    # "kernel" is the launch alone on packed edges; "wrapper" adds the
    # packing and the orthonormalization around it, as the plain version's
    # time does
    obs = batch_obs([make_problem(2048)], dev)
    obs1 = pose_opt.PoseObs(*[x[0] for x in obs])
    eye = torch.eye(4, device=dev)
    data = pose_opt_cuda.pack_edges(obs)
    pose12 = eye[None, :3, :].reshape(1, 12).contiguous()
    ms_k = _time_ms(lambda: pose_opt_cuda.pose_lm_raw(CAM, data, pose12))
    ms_w = _time_ms(lambda: pose_opt_cuda.pose_optimization_cuda(CAM, eye[None], obs))
    ms_p = _time_ms(lambda: pose_opt.pose_optimization_ref(CAM, eye, obs1))
    log(f"[kernel] M=2048 B=1: kernel {ms_k:.4f} ms, wrapper {ms_w:.4f} ms, "
        f"plain {ms_p:.4f} ms (CUDA events, median of 50), "
        f"max |pose err| {worst:.3g}")
    return dict(max_abs_err=worst, ms=ms_k, plain_ms=ms_p)


def phase_slice(dev) -> dict:
    from orbslam_mapsave_tpu_torch import config as cfg_mod
    from orbslam_mapsave_tpu_torch.io import synthetic, trajectory as traj_io
    from orbslam_mapsave_tpu_torch.optim import pose_opt_cuda
    from orbslam_mapsave_tpu_torch.pipeline import system as system_mod

    t0 = time.perf_counter()
    K = np.array([[520.0, 0, W / 2], [0, 520.0, H / 2], [0, 0, 1.0]])
    poses = synthetic.circle_trajectory(N_FRAMES, radius=0.55, revs=1.30)
    room = synthetic.BoxRoom(half_size=2.0, seed=11)
    frames = []
    for i in range(N_FRAMES):
        gray, depth = room.render(K, poses[i], W, H)
        frames.append((np.clip(gray, 0, 255).astype(np.uint8),
                       depth.astype(np.float16)))
    log(f"[slice] rendered {N_FRAMES} frames in {time.perf_counter() - t0:.1f} s")

    cfg = cfg_mod.SystemConfig()
    cfg.camera = cfg_mod.CameraConfig(
        fx=520.0, fy=520.0, cx=W / 2, cy=H / 2, width=W, height=H,
        bf=520.0 * 0.08, th_depth=50.0, fps=30)
    cfg.orb = cfg_mod.ORBConfig(n_features=2000, n_levels=4, scale_factor=1.5)
    cfg.max_keypoints = 2048
    cfg.max_keyframes = 64
    cfg.max_points = 32768
    slam = system_mod.SLAMSystem(cfg, system_mod.Sensor.RGBD,
                                 enable_mapping=False, device=dev)
    stamps = 1000.0 + np.arange(N_FRAMES) / 30.0
    # warm-up (cuBLAS/cuDNN handles, allocator), then the measured run
    for i in range(10):
        slam.track_rgbd(*frames[i], stamps[i])
    slam.reset()
    torch.cuda.synchronize()

    pose_opt_cuda.reset_launches()
    frame_ms = np.empty(N_FRAMES)
    t_start = time.perf_counter()
    for i in range(N_FRAMES):
        t1 = time.perf_counter()
        pose = slam.track_rgbd(*frames[i], stamps[i])
        torch.cuda.synchronize()
        frame_ms[i] = 1e3 * (time.perf_counter() - t1)
        if pose.shape != (4, 4) or not np.isfinite(pose).all():
            raise AssertionError(f"frame {i}: bad pose {pose}")
    wall = time.perf_counter() - t_start
    launches = pose_opt_cuda.launches

    traj = slam.tracker.trajectory
    lost = [i for i, (_, _, l) in enumerate(traj) if l]
    ts, est = slam.keyframe_trajectory()
    kf_ate = traj_io.ate_rmse(stamps, poses, ts, np.linalg.inv(est))
    n_kf, n_pt = slam.n_keyframes, slam.n_points
    tracked = N_FRAMES - 1 - len(lost)  # frame 0 initializes the map
    res = dict(frames=N_FRAMES, fps=N_FRAMES / wall,
               p50_ms=float(np.percentile(frame_ms, 50)),
               p99_ms=float(np.percentile(frame_ms, 99)),
               keyframes=n_kf, points=n_pt, kf_ate_m=kf_ate, lost=len(lost),
               launches=launches)
    log("[slice] " + json.dumps(res))
    if lost:
        raise AssertionError(f"frames lost: {lost}")
    if abs(n_kf - JAX_CPU_KEYFRAMES) > 0.2 * JAX_CPU_KEYFRAMES:
        raise AssertionError(f"{n_kf} keyframes vs JAX CPU {JAX_CPU_KEYFRAMES}")
    if not kf_ate <= JAX_CPU_KF_ATE_M + 0.01:
        raise AssertionError(f"kf ATE {kf_ate:.4f} m vs JAX CPU {JAX_CPU_KF_ATE_M:.4f} m")
    if launches < 2 * tracked:
        raise AssertionError(f"{launches} pose-LM launches for {tracked} tracked frames")
    return res


def main() -> int:
    try:
        smi = phase_device()
        dev = torch.device("cuda", 0)
        phase_build()
        kres = phase_kernel(dev)
        sres = phase_slice(dev)
    except Exception as e:  # every phase failure ends here, with no result
        import traceback

        traceback.print_exc()
        log(f"[chip_smoke] FAILED: {type(e).__name__}: {e}")
        return 1
    print(json.dumps({"kernels": [{
        "name": "pose_lm",
        "route": "cuda",
        "source": "orbslam_mapsave_tpu_torch/csrc/pose_lm.cu",
        "replaces": "orbslam_mapsave_tpu/optim/pose_opt_pallas.py:139",
        "launches": sres["launches"],
        "max_abs_err": kres["max_abs_err"],
        "ms": kres["ms"],
        "plain_ms": kres["plain_ms"],
    }]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
