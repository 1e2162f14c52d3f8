"""Smoke test of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each raises on failure; the script then exits non-zero and prints
no result):

1. device   — a CUDA card must be present; prints its name and power limit.
2. build    — compiles the pose-LM kernel (csrc/pose_lm.cu) with nvcc and
              prints ptxas's report; any register spill fails.
3. kernel   — the kernel against its plain PyTorch version on the card at
              M = 2048, 900, 1024 edges and B = 1, 4 problems: pose max-abs
              <= 1e-4, identical inlier sets and counts (a flip is accepted
              only within 1e-4 relative of its chi2 gate, and printed), two
              runs bit-identical; all-invalid and all-behind edge sets return
              the input pose. Then CUDA-event timings (median of 50) at
              M = 2048, B = 1 and 4: one synchronous call of the wrapper
              (its one launch), the kernel alone (replays of a CUDA graph
              of launches), the plain version (B = 1), per-LM-iteration
              microseconds as (t(n_iters=10) - t(n_iters=5)) / 20 at M = 2048
              and M = 128, and the share of an iteration that grows with M.
4. slice    — the benchmark sequence (bench.py: 640x480, 2000 ORB features,
              circle_trajectory(240, radius=0.55, revs=1.30) in a
              BoxRoom(2.0, seed=11), u8 image + f16 depth) through
              SLAMSystem RGB-D tracking at max_keypoints=2048,
              max_keyframes=64, max_points=32768: no frame lost, keyframe
              count within 20% of the JAX package's CPU run, keyframe ATE
              within 1 cm of it, and exactly one pose-LM launch per pose
              optimization (>= 2 per tracked frame).
5. profile  — a torch.profiler trace of 10 calls shows 10 device kernels,
              all pose_lm_kernel (last: a profile slows later launches).

The last lines are a JSON record of the kernels, the card's
`nvidia-smi` name/power line, and {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

# JAX package, CPU, same sequence and configuration with enable_mapping=False
# and no vocabulary (measured once; see PERF.md): 240 frames, none lost.
JAX_CPU_KEYFRAMES = 23
JAX_CPU_KF_ATE_M = 0.023118204057347373
N_FRAMES = 240
W, H = 640, 480
POSE_TOL = 1e-4  # kernel vs plain: f32 sums in another order
GATE_REL = 1e-4  # an inlier may flip only this close (relative) to its gate

# H100 SXM peaks (NVIDIA data sheet): f32 outside the tensor cores, HBM3
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12
N_SM = 132
# FLOP per edge of csrc/pose_lm.cu, (mono, stereo), counted from its source
# without the products of the Jacobians' zero entries (Ju[1], Jv[0], Jur[1],
# and all of Jur on a mono edge); a division or square root counts one. The
# residual (camera point 18, 1/z 1, projection 6 + uR 2, errors 2 + 1, chi2
# 4 / 6) is what a pass needs of an edge it reads; an inlier's system terms
# add the Jacobians (17 / 22), 21 H entries (80 / 110) and 6 g entries
# (26 / 36), and its cost one add. Left out, so the count stays a lower
# bound: the Huber weight (<= 4 per edge over its gate, rounds 0-1) and the
# 6x6 solve (~600 per iteration, < 1%).
FLOP_RESIDUAL = (31, 36)
FLOP_SYSTEM = (123, 168)
FLOP_COST = 1
BYTES_PER_EDGE = 12 + 8 + 4 + 4 + 1 + 1  # pt_w uv ur inv_sigma2 valid in, inlier out
BYTES_PER_PROBLEM = 64 + 64 + 4  # pose in, pose and count out


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


def _ptxas_report(lib: Path) -> str:
    text = lib.with_suffix(".ptxas.txt").read_text()
    spills = [int(n) for n in re.findall(r"(\d+) bytes spill (?:stores|loads)", text)]
    if not spills or any(spills):
        raise AssertionError(f"ptxas reports spills (or no report):\n{text}")
    return text


def phase_build():
    from orbslam_mapsave_tpu_torch.optim import pose_opt_cuda

    t0 = time.perf_counter()
    path = pose_opt_cuda.build()
    log(f"[build] {path.name} in {time.perf_counter() - t0:.2f} s")
    log("[build] ptxas: " + _ptxas_report(path).strip().replace("\n", "\n[build] ptxas: "))


def _time_ms(fn, n=50) -> float:
    """Median of n synchronous calls, each between two CUDA events."""
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


def _time_kernel_ms(fn, n=50, per=5) -> float:
    """Device time of one launch: median over n replays of a CUDA graph
    that holds `per` calls, so no host work sits between the launches."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(per):
            fn()
    times = []
    for _ in range(n + 3):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / per)
    return statistics.median(times[3:])


def _per_iter_us(kern) -> float:
    """Microseconds per LM iteration: (t(n_iters=10) - t(n_iters=5)) / 20,
    20 being the 4 rounds x 5 iterations between the two."""
    return 1e3 * (_time_kernel_ms(lambda: kern(10)) - _time_kernel_ms(lambda: kern(5))) / 20


def _check_inliers(cam, pose_k, inl_k, n_k, pose_r, inl_r, obs1) -> int:
    """Inlier sets must be equal, except an edge whose raw chi2 lies within
    GATE_REL (relative) of its gate at either pose; returns the flips."""
    from orbslam_mapsave_tpu_torch.optim import lm, pose_opt

    if int(n_k) != int(inl_k.sum()):
        raise AssertionError(f"kernel count {int(n_k)} != mask sum {int(inl_k.sum())}")
    flips = torch.nonzero(inl_k != inl_r).flatten()
    for e in flips.tolist():
        gate = lm.CHI2_STEREO if float(obs1.ur[e]) >= 0 else lm.CHI2_MONO
        margins = [float(pose_opt._residuals(cam, p, obs1)[3][e]) / gate - 1.0
                   for p in (pose_k, pose_r)]
        log(f"[kernel] inlier flip at edge {e}: chi2/gate - 1 = {margins[0]:.3g} "
            f"(kernel pose), {margins[1]:.3g} (plain pose)")
        if min(abs(m) for m in margins) > GATE_REL:
            raise AssertionError(f"inlier flip at edge {e} is not at its gate")
    return len(flips)


def _round_inliers(pose0, obs1) -> list[torch.Tensor]:
    """Each round's inlier set in a run of the plain version on one
    problem, which the kernel matches: the valid edges in round 0, then the
    reclassification that opens each later round."""
    from orbslam_mapsave_tpu_torch.optim import pose_opt
    from orbslam_mapsave_tpu_torch.optim.pose_problem import CAM

    sets = [obs1.valid]
    reclassify = pose_opt._reclassify

    def recorded(*args):
        sets.append(reclassify(*args))
        return sets[-1]

    pose_opt._reclassify = recorded
    try:
        pose_opt.pose_optimization_ref(CAM, pose0, obs1)
    finally:
        pose_opt._reclassify = reclassify
    return sets[:-1]  # the last reclassification is the output pass


def _flops(pose0, obs1, n_iters=10) -> int:
    """The FLOPs one problem's call needs on its data: every pass reads the
    residual of the edges it needs (all valid edges when it reclassifies,
    else the round's inliers) and adds the inliers' system terms."""
    from orbslam_mapsave_tpu_torch.optim import pose_opt
    from orbslam_mapsave_tpu_torch.optim.pose_problem import CAM

    stereo = obs1.ur >= 0

    def count(mask, per):
        return per[0] * int((mask & ~stereo).sum()) + per[1] * int((mask & stereo).sum())

    behind = pose_opt._residuals(CAM, pose0, obs1)[5]  # round 0 takes them as inliers
    flops = count(obs1.valid, FLOP_RESIDUAL)  # the output pass
    for inl in _round_inliers(pose0, obs1):
        system = count(inl & ~behind, FLOP_SYSTEM) + FLOP_COST * int(inl.sum())
        flops += count(obs1.valid, FLOP_RESIDUAL) + system  # the round's first pass
        flops += n_iters * (count(inl, FLOP_RESIDUAL) + system)
    return flops


def _bound_ms(pose0, obs) -> tuple[float, str, float, int]:
    """(least time on the whole card, what bounds it, least time on one SM,
    FLOPs) for one call on these inputs; a problem runs on one SM, so the
    one-SM time is the largest problem's."""
    from orbslam_mapsave_tpu_torch.optim import pose_opt

    B, M = obs.valid.shape
    flops = [_flops(pose0[b], pose_opt.PoseObs(*[x[b] for x in obs])) for b in range(B)]
    t_ops = sum(flops) / PEAK_F32
    t_bytes = (B * M * BYTES_PER_EDGE + B * BYTES_PER_PROBLEM) / PEAK_BYTES
    sm_ms = 1e3 * max(flops) / (PEAK_F32 / N_SM)
    return (1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes",
            sm_ms, sum(flops))


def _cuda_kernels_per_call(fn, calls=10) -> list[str]:
    """Names of the device kernels a profile records while fn runs `calls`
    times. The calls sit between two marker kernels (fills), after warm-up
    calls inside the same profile: the first launches after the profiler
    starts can go unrecorded."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            fn()
        torch.ones(1, device="cuda")
        for _ in range(calls):
            fn()
        torch.ones(1, device="cuda")
        torch.cuda.synchronize()
    events = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA),
                    key=lambda e: e.time_range.start)
    names = [e.name for e in events]
    marks = [i for i, n in enumerate(names) if "pose_lm_kernel" not in n]
    if len(marks) < 2:
        raise AssertionError(f"profile lost its marker kernels: {names}")
    return names[marks[-2] + 1:marks[-1]]


def phase_kernel(dev) -> dict:
    from orbslam_mapsave_tpu_torch.optim import pose_opt, pose_opt_cuda
    from orbslam_mapsave_tpu_torch.optim.pose_problem import (CAM, batch_obs,
                                                              make_problem)

    worst, flips = 0.0, 0
    for M in (2048, 900, 1024):
        for B in (1, 4):
            probs = [make_problem(M, seed=7 + b) for b in range(B)]
            obs = batch_obs(probs, dev)
            pose0 = torch.eye(4, device=dev).expand(B, 4, 4).contiguous()
            p1, i1, n1 = pose_opt_cuda.pose_optimization_cuda(CAM, pose0, obs)
            p2, i2, n2 = pose_opt_cuda.pose_optimization_cuda(CAM, pose0, obs)
            torch.cuda.synchronize()
            if not (torch.equal(p1, p2) and torch.equal(i1, i2) and torch.equal(n1, n2)):
                raise AssertionError(f"kernel not bit-repeatable at M={M} B={B}")
            for b in range(B):
                obs1 = pose_opt.PoseObs(*[x[b] for x in obs])
                pr, ir, nr = pose_opt.pose_optimization_ref(CAM, pose0[b], obs1)
                err = (p1[b] - pr).abs().max().item()
                worst = max(worst, err)
                if not err <= POSE_TOL:
                    raise AssertionError(f"kernel != plain at M={M} B={B} b={b}: "
                                         f"pose err {err:.3g}")
                flips += _check_inliers(CAM, p1[b], i1[b], n1[b], pr, ir, obs1)
            log(f"[kernel] M={M} B={B}: ok (inliers {n1.tolist()})")
    for case in ("all_invalid", "all_behind"):
        p = make_problem(1024, seed=3)
        if case == "all_invalid":
            p["valid"][:] = False
        else:
            p["pt_w"][:, 2] *= -1.0
        pose0 = torch.eye(4, device=dev)[None].contiguous()
        pose, inl, n = pose_opt_cuda.pose_optimization_cuda(CAM, pose0, batch_obs([p], dev))
        if not (torch.equal(pose, pose0) and int(n[0]) == 0 and not bool(inl.any())):
            raise AssertionError(f"{case}: the input pose must come back unchanged")
        log(f"[kernel] {case}: input pose returned, 0 inliers")

    # the main path's shape: one problem of M = max_keypoints; B = 4 as
    # relocalization would batch candidates
    eye = torch.eye(4, device=dev)
    res = {}
    for B in (1, 4):
        obs = batch_obs([make_problem(2048, seed=7 + b) for b in range(B)], dev)
        pose0 = eye.expand(B, 4, 4).contiguous()

        def kern(n_iters=10, o=obs):
            return pose_opt_cuda.pose_optimization_cuda(CAM, pose0, o, n_iters=n_iters)

        # ms: one synchronous call between two events (host and launch
        # inside, as PR 1's `ms`); graph_ms: device time of one launch
        r = dict(ms=_time_ms(kern), graph_ms=_time_kernel_ms(kern))
        for M in (2048, 128):
            o = pose_opt.PoseObs(*[x[:, :M].contiguous() for x in obs])
            r[f"per_iter_us_M{M}"] = _per_iter_us(lambda n, o=o: kern(n, o))
        r["edge_pass_share"] = 1.0 - r["per_iter_us_M128"] / r["per_iter_us_M2048"]
        r["bound_ms"], r["bound_by"], r["sm_bound_ms"], r["flops"] = _bound_ms(pose0, obs)
        if B == 1:
            obs1 = pose_opt.PoseObs(*[x[0] for x in obs])
            r["plain_ms"] = _time_ms(lambda: pose_opt.pose_optimization_ref(CAM, eye, obs1))
        res[B] = r
        log(f"[timing] M=2048 B={B} (CUDA events, median of 50): " + json.dumps(r))
    log(f"[kernel] max |pose err| {worst:.3g}, inlier flips at the gate: {flips}")
    return dict(max_abs_err=worst, flips=flips, timing=res)


def phase_profile(dev):
    """One device kernel per call, and no other, in a torch.profiler trace.
    Runs last: after a profile, every launch of the process costs the host
    more (the profiler's CUPTI hooks stay), which would skew the timings."""
    from orbslam_mapsave_tpu_torch.optim import pose_opt_cuda
    from orbslam_mapsave_tpu_torch.optim.pose_problem import (CAM, batch_obs,
                                                              make_problem)

    for B in (1, 4):
        obs = batch_obs([make_problem(2048, seed=7 + b) for b in range(B)], dev)
        pose0 = torch.eye(4, device=dev).expand(B, 4, 4).contiguous()
        names = _cuda_kernels_per_call(
            lambda: pose_opt_cuda.pose_optimization_cuda(CAM, pose0, obs))
        if len(names) != 10:
            raise AssertionError(f"10 calls ran {len(names)} device kernels "
                                 f"{sorted(set(names))}, not 10 x pose_lm_kernel")
        log(f"[profile] B={B}: 10 calls ran 10 device kernels, all pose_lm_kernel")


def phase_slice(dev) -> dict:
    from orbslam_mapsave_tpu_torch import config as cfg_mod
    from orbslam_mapsave_tpu_torch.io import synthetic, trajectory as traj_io
    from orbslam_mapsave_tpu_torch.optim import pose_opt, pose_opt_cuda
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

    # count the pose optimizations the tracker asks for, beside the launches
    calls = 0
    dispatch = pose_opt.pose_optimization

    def counted(*args):
        nonlocal calls
        calls += 1
        return dispatch(*args)

    pose_opt.pose_optimization = counted
    pose_opt_cuda.reset_launches()
    frame_ms = np.empty(N_FRAMES)
    try:
        t_start = time.perf_counter()
        for i in range(N_FRAMES):
            t1 = time.perf_counter()
            pose = slam.track_rgbd(*frames[i], stamps[i])
            torch.cuda.synchronize()
            frame_ms[i] = 1e3 * (time.perf_counter() - t1)
            if pose.shape != (4, 4) or not np.isfinite(pose).all():
                raise AssertionError(f"frame {i}: bad pose {pose}")
        wall = time.perf_counter() - t_start
    finally:
        pose_opt.pose_optimization = dispatch
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
               pose_optimizations=calls, launches=launches)
    log("[slice] " + json.dumps(res))
    if lost:
        raise AssertionError(f"frames lost: {lost}")
    if abs(n_kf - JAX_CPU_KEYFRAMES) > 0.2 * JAX_CPU_KEYFRAMES:
        raise AssertionError(f"{n_kf} keyframes vs JAX CPU {JAX_CPU_KEYFRAMES}")
    if not kf_ate <= JAX_CPU_KF_ATE_M + 0.01:
        raise AssertionError(f"kf ATE {kf_ate:.4f} m vs JAX CPU {JAX_CPU_KF_ATE_M:.4f} m")
    if launches != calls or calls < 2 * tracked:
        raise AssertionError(f"{launches} pose-LM launches for {calls} pose "
                             f"optimizations in {tracked} tracked frames")
    return res


def main() -> int:
    try:
        smi = phase_device()
        dev = torch.device("cuda", 0)
        phase_build()
        kres = phase_kernel(dev)
        sres = phase_slice(dev)
        phase_profile(dev)
    except Exception as e:  # every phase failure ends here, with no result
        import traceback

        traceback.print_exc()
        log(f"[chip_smoke] FAILED: {type(e).__name__}: {e}")
        return 1
    t1 = kres["timing"][1]
    print(json.dumps({"kernels": [{
        "name": "pose_lm",
        "route": "cuda",
        "source": "orbslam_mapsave_tpu_torch/csrc/pose_lm.cu",
        "replaces": "orbslam_mapsave_tpu/optim/pose_opt_pallas.py:139",
        "launches": sres["launches"],
        "max_abs_err": kres["max_abs_err"],
        "ms": t1["ms"],
        "plain_ms": t1["plain_ms"],
        "bound_ms": t1["bound_ms"],
        "bound_by": t1["bound_by"],
        "library_ms": None,
        "graph_ms": t1["graph_ms"],
        "per_iter_us": t1["per_iter_us_M2048"],
        "edge_pass_share": t1["edge_pass_share"],
        "sm_bound_ms": t1["sm_bound_ms"],
    }]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
