"""The JAX package's numbers on the benchmark sequence, on the CPU, for
`chip_smoke.py` to hold the PyTorch port against (the port's card cannot
run JAX).

    JAX_PLATFORMS=cpu python tools/jax_cpu_bench_reference.py \
        [--no-mapping | --loop | --kidnap | --reuse | --mono | --stereo |
         --endurance | --scale [--frames S]] [--default-caps] [--devices N]

Runs bench.py's sequence and configuration (640x480, 2000 ORB features,
circle_trajectory(240, radius=0.55, revs=1.30) in BoxRoom(2.0, seed=11),
u8 image + f16 depth, max_keypoints=2048, max_keyframes=64,
max_points=32768) through `SLAMSystem` with local mapping and no
vocabulary (the default, bench.py with BENCH_NO_LOOP=1), tracking only
(`--no-mapping`), or bench.py's headline configuration (`--loop`: a
vocabulary trained from frames 0, 12, ..., 228 with k=10, L=4, seed=1, and
loop closing on). `--loop` reads the tracker's outcomes every frame
(`fetch_every = 1`), as the port does, unless `--fetch-every` says
otherwise; the loop events depend on that cadence. Prints one JSON line:
keyframes, points, keyframe ATE, lost frames, keyframe frames, BA lanes
dropped, seconds, and with `--loop` the vocabulary size and the loop events
(query/match keyframe slots and frame ids, inliers).

`--kidnap` runs the headline configuration over frames 0-149, then 3
blank frames (zero image and depth), then the images of frames 100-239
with timestamps that continue the clock (293 frames): the camera is lost
and put back into a part of the room it has already mapped. It prints the
frames tracked as lost, the frame on which relocalization succeeded after
the blanks, keyframes, points and the keyframe ATE against the ground
truth of the frames shown.

`--kidnap --trace` also prints, per keyframe that ran a loop detection,
its candidates with their BoW scores, each candidate group's consistency
count and the candidates that passed, and per Sim3 chain read its
acceptance and inliers. `--port` runs the kidnap sequence through the
PyTorch port (orbslam_mapsave_tpu_torch) on the CPU instead, with the
vocabulary the port trains from its own frames, or with `--jax-vocabulary`
the JAX package's, handed over as a .bin file: the two vocabularies differ
where ORB rounding ties change a training descriptor, and loop detection
follows the vocabulary. The port takes ~50 min for the 293 frames.

`--reuse` runs the headline configuration over the 240 frames, saves the
map with its BoW rows (`save_map`), reloads it with
`SLAMSystem(..., reuse_map_path=...)` (localization only, starting LOST)
and runs the 240 frames again: the first relocalized frame, the localized
frames, the ATE of the localized frames' poses against the ground truth,
and the loaded and final keyframe / point counts.

`--mono` runs tools/bench_mono.py's workload: the same 240 frames, the
u8 image alone, through `SLAMSystem(cfg, Sensor.MONOCULAR)` with
max_keyframes=96, bench.py's vocabulary and loop closing on (Sim3 with a
free scale), one pass from a fresh system. It prints the bootstrap frame
(the first frame not lost), the lost frames, keyframes, points, the
Sim3-aligned keyframe ATE (`ate_rmse(..., with_scale=True)`: mono scale is
free), the loop events, the global-BA jobs applied and aborted, and the BA
lanes dropped (in the per-frame step and in the bootstrap pair's mapping
passes).

`--stereo` runs the stereo workload of `chip_smoke.py`: the same 240
frames as u8 left images, each with a right image rendered from the pose
moved +0.08 m along the camera x axis (as `io/synthetic.write_stereo_sequence`
renders a rig; bf = 520 x 0.08 = 41.6, the bench camera's own), through
`SLAMSystem(cfg, Sensor.STEREO)` with bench.py's vocabulary and loop
closing on, one pass from a fresh system. It prints the lost frames,
keyframes, points, keyframe ATE, the loop events, the global-BA jobs
applied and aborted with the solver each ran, the essential graph's solver
and the BA lanes dropped.

`--default-caps` runs `--loop` or `--stereo` at `SystemConfig`'s default
capacities (512 keyframes, 65,536 points, 2,048 keypoints), which select
the CG essential graph and the `pcg_dual` global-BA job, instead of
bench.py's 64 keyframes and 32,768 points.

`--endurance` runs tools/endurance.py's workload (1,200 frames at 640x480,
max_keyframes 256, max_points 49,152, bench.py's vocabulary) and `--scale`
the first S frames (`--frames`, default 1,700: `chip_smoke.SCALE_FRAMES`;
~19 min) of tools/scale_endurance.py's
8,000-frame sweep at K_cap 1,536 / P_cap 262,144 / N 1,024 with its own
vocabulary (frames 0, 60, ..., 7,980), both from
tools/scale_endurance_torch.py's definitions, one pass from a fresh system.
They print the lost frames, live keyframes, the keyframe allocator's high
water mark, points, kf ATE (whole run and per 1,000 frames), the loop
events (frame ids read when each is corrected), the global-BA jobs applied
and aborted with their solvers, the essential graphs' solvers, the point
and keyframe compactions, and the BA escalations and dropped lanes.

All of them read the tracker's outcomes every frame (`fetch_every = 1`).
`--devices N` runs JAX on N virtual CPU devices (it sets
`XLA_FLAGS=--xla_force_host_platform_device_count=N` before JAX starts;
default 1): past one device the JAX package's GBAJob runs
`parallel/dist_gba.distributed_full_ba` and its relocalizer the sharded
query of `parallel/dist_reloc` (`gba_solvers` then reads "multi-device").
Every JSON line records N as `devices`.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from pathlib import Path


def _devices_arg(argv: list[str]) -> int:
    """`--devices N` (default 1), read before JAX starts: N virtual CPU
    devices, so that the JAX package takes its multi-device branches."""
    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("--devices", type=int, default=1)
    return ap.parse_known_args(argv)[0].devices


DEVICES = _devices_arg(sys.argv[1:])
os.environ["XLA_FLAGS"] = " ".join(
    [f for f in os.environ.get("XLA_FLAGS", "").split()
     if "xla_force_host_platform_device_count" not in f]
    + [f"--xla_force_host_platform_device_count={DEVICES}"])

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
jax.config.update("jax_platforms", "cpu")

from orbslam_mapsave_tpu import config as cfg_mod  # noqa: E402
from orbslam_mapsave_tpu.io import synthetic, trajectory as traj_io  # noqa: E402
from orbslam_mapsave_tpu.pipeline import system as system_mod  # noqa: E402
from orbslam_mapsave_tpu.pipeline import tracking as tracking_mod  # noqa: E402

N, W, H = 240, 640, 480
KIDNAP_AT, KIDNAP_BLANKS, KIDNAP_RESUME = 150, 3, 100
BASELINE = 0.08  # m: bf = 520 x 0.08, the bench camera's


def _config(mod=cfg_mod, default_caps: bool = False):
    cfg = mod.SystemConfig()
    cfg.camera = mod.CameraConfig(fx=520.0, fy=520.0, cx=W / 2, cy=H / 2, width=W,
                                  height=H, bf=520.0 * BASELINE, th_depth=50.0, fps=30)
    cfg.orb = mod.ORBConfig(n_features=2000, n_levels=4, scale_factor=1.5)
    if not default_caps:
        cfg.max_keypoints, cfg.max_keyframes, cfg.max_points = 2048, 64, 32768
    return cfg


def right_twc(Twc: np.ndarray) -> np.ndarray:
    """The right camera of the rig: Twc moved BASELINE along its own x axis
    (`io/synthetic.write_stereo_sequence`)."""
    out = Twc.copy()
    out[:3, 3] = Twc[:3, 3] + Twc[:3, :3] @ np.array([BASELINE, 0.0, 0.0])
    return out


def _gba_bookkeeping(gba_mod, pose_graph_mod) -> dict:
    """Count the global-BA jobs applied and aborted, the solver each job
    picked and the essential graph's solver (recorded when its program is
    traced), by wrapping the JAX classes and functions in place."""
    rec = {"applied": 0, "aborted": 0, "gba_solvers": [], "essential_solvers": []}
    init, apply, abort = gba_mod.GBAJob.__init__, gba_mod.GBAJob.apply, gba_mod.GBAJob.abort
    solve = pose_graph_mod.optimize_pose_graph

    def counted_init(job, *a, **k):
        init(job, *a, **k)
        rec["gba_solvers"].append(getattr(job, "_solver", "multi-device"))

    def counted_apply(job, state):
        rec["applied"] += not job.aborted
        return apply(job, state)

    def counted_abort(job):
        rec["aborted"] += not job.aborted
        return abort(job)

    def recorded_solve(prob, *a, **k):
        rec["essential_solvers"].append(k.get("solver", "dense"))
        return solve(prob, *a, **k)

    gba_mod.GBAJob.__init__, gba_mod.GBAJob.apply = counted_init, counted_apply
    gba_mod.GBAJob.abort = counted_abort
    pose_graph_mod.optimize_pose_graph = recorded_solve
    return rec


def _stereo(cfg, voc, frames, poses, stamps) -> dict:
    from orbslam_mapsave_tpu.optim import pose_graph
    from orbslam_mapsave_tpu.pipeline import gba as gba_mod

    rec = _gba_bookkeeping(gba_mod, pose_graph)
    slam = system_mod.SLAMSystem(cfg, system_mod.Sensor.STEREO, vocabulary=voc)
    slam.tracker.fetch_every = 1
    for (left, right), t in zip(frames, stamps):
        slam.track_stereo(left, right, t)
        slam.tracker.flush()
    slam.flush_gba()
    traj = slam.tracker.trajectory
    valid = np.asarray(slam.map.kf_valid)
    fid = np.asarray(slam.map.kf_frame_id)
    map_dropped = slam.mapper.ba_lane_stats()[0] if slam.mapper is not None else 0
    return dict(
        caps=[cfg.max_keyframes, cfg.max_points, cfg.max_keypoints],
        motion_th=slam.tracker.cfg.motion_th, local_th=slam.tracker.cfg.local_th,
        lost_frames=[j for j, (_, _, l) in enumerate(traj) if l],
        keyframes=slam.n_keyframes, points=slam.n_points,
        kf_ate_m=_kf_ate(slam, stamps, poses), kf_frame_ids=fid[valid].tolist(),
        loops=len(slam.loop_closer.events),
        events=[dict(query_frame=int(fid[e.query_kf]), match_frame=int(fid[e.match_kf]),
                     inliers=e.n_inliers) for e in slam.loop_closer.events],
        gba_applied=rec["applied"], gba_aborted=rec["aborted"],
        gba_solvers=rec["gba_solvers"], essential_solvers=rec["essential_solvers"],
        ba_lanes_dropped=slam.tracker.ba_lanes_dropped + map_dropped)


def _descriptors(cfg, frames, stamps) -> np.ndarray:
    """bench.py's training descriptors: frames 0, 12, ..., 228."""
    trainer = system_mod.SLAMSystem(cfg, system_mod.Sensor.RGBD, vocabulary=None,
                                    enable_loop_closing=False)
    descs = []
    for i in range(0, N, 12):
        fr = trainer.builder.build(jnp.asarray(frames[i][0]), stamps[i],
                                   jnp.asarray(frames[i][1]))
        descs.append(np.asarray(fr.desc)[np.asarray(fr.valid)])
    return np.concatenate(descs)


def _vocabulary(cfg, frames, stamps):
    from orbslam_mapsave_tpu.vocab import vocabulary

    return vocabulary.train(_descriptors(cfg, frames, stamps), k=10, L=4, seed=1)


def _kf_ate(slam, gt_ts, gt_poses, with_scale: bool = False) -> float:
    valid = np.asarray(slam.map.kf_valid)
    ts = np.asarray(slam.map.kf_timestamp, np.float64)[valid] + slam.tracker.ts_epoch
    est = np.asarray(slam.map.kf_pose)[valid]
    return float(traj_io.ate_rmse(gt_ts, gt_poses, ts, np.linalg.inv(est),
                                  with_scale=with_scale))


def _mono(cfg, voc, frames, poses, stamps) -> dict:
    from orbslam_mapsave_tpu.pipeline import gba as gba_mod

    cfg.max_keyframes = 96  # tools/bench_mono.py: mono culls harder
    jobs = {"applied": 0, "aborted": 0}
    apply, abort = gba_mod.GBAJob.apply, gba_mod.GBAJob.abort

    def counted_apply(job, state):
        jobs["applied"] += not job.aborted
        return apply(job, state)

    def counted_abort(job):
        jobs["aborted"] += not job.aborted
        return abort(job)

    gba_mod.GBAJob.apply, gba_mod.GBAJob.abort = counted_apply, counted_abort
    slam = system_mod.SLAMSystem(cfg, system_mod.Sensor.MONOCULAR, vocabulary=voc)
    slam.tracker.fetch_every = 1
    for (gray, _), t in zip(frames, stamps):
        slam.track_monocular(gray, t)
        slam.tracker.flush()
    slam.flush_gba()
    traj = slam.tracker.trajectory
    lost = [j for j, (_, _, l) in enumerate(traj) if l]
    valid = np.asarray(slam.map.kf_valid)
    fid = np.asarray(slam.map.kf_frame_id)
    map_dropped, _ = slam.mapper.ba_lane_stats()
    return dict(
        bootstrap_frame=next((j for j, (_, _, l) in enumerate(traj) if not l), None),
        lost_frames=lost, keyframes=slam.n_keyframes, points=slam.n_points,
        kf_ate_sim3_m=_kf_ate(slam, stamps, poses, with_scale=True),
        kf_frame_ids=fid[valid].tolist(), loops=len(slam.loop_closer.events),
        events=[dict(query_frame=int(fid[e.query_kf]), match_frame=int(fid[e.match_kf]),
                     inliers=e.n_inliers) for e in slam.loop_closer.events],
        gba_applied=jobs["applied"], gba_aborted=jobs["aborted"],
        ba_lanes_dropped=slam.tracker.ba_lanes_dropped + map_dropped)


def _drive(slam, frames, stamps) -> list[int]:
    """Track every frame with outcomes read every frame; returns the
    tracker's state after each frame (after any relocalization)."""
    slam.tracker.fetch_every = 1
    states = []
    for (gray, depth), t in zip(frames, stamps):
        slam.track_rgbd(gray, depth, t)
        slam.tracker.flush()
        states.append(slam.tracker.state)
    slam.flush_gba()
    return states


def _np(x) -> np.ndarray:
    return x.cpu().numpy() if hasattr(x, "cpu") else np.asarray(x)


def _traced(lc, trace: list):
    """Record the loop closer's detections and Sim3 reads into `trace`."""
    detect, poll = lc._detect_host, lc._poll_sim3

    def traced_detect(kf, fut):
        out = detect(kf, fut)
        ids, scores = _np(fut[0]), _np(fut[1])
        live = np.isfinite(scores)
        trace.append(dict(kf=int(kf), candidates=[(int(c), round(float(v), 5)) for c, v in
                                                  zip(ids[live], scores[live])],
                          consistency=[c for _, c in lc.consistent_groups],
                          passed=[int(c) for c in out]))
        return out

    def traced_poll(state):
        if lc._pending_sim3 is not None:
            kf, cands, fut = lc._pending_sim3
            trace.append(dict(sim3_kf=int(kf), candidates=[int(c) for c in cands],
                              accept=bool(_np(fut["accept"])), inliers=int(_np(fut["n2"]))))
        return poll(state)

    lc._detect_host, lc._poll_sim3 = traced_detect, traced_poll


def _port_system(voc):
    from orbslam_mapsave_tpu_torch import config as tcfg
    from orbslam_mapsave_tpu_torch.pipeline import system as tsys

    return tsys.SLAMSystem(_config(tcfg), tsys.Sensor.RGBD, vocabulary=voc, device="cpu")


def _port_vocabulary(frames, stamps, jax_voc=None):
    """The port's vocabulary: trained as bench.py trains it, on the port's
    FrameBuilder, or the JAX package's `jax_voc` read back from a .bin.
    Returns (vocabulary, the port's training descriptors or None)."""
    from orbslam_mapsave_tpu_torch.vocab import vocabulary as tvoc

    if jax_voc is not None:
        from orbslam_mapsave_tpu.vocab import vocabulary

        with tempfile.TemporaryDirectory() as d:
            vocabulary.save_binary(Path(d) / "voc.bin", jax_voc)
            return tvoc.load_binary(Path(d) / "voc.bin"), None
    builder = _port_system(None).builder
    descs = []
    for i in range(0, N, 12):
        fr = builder.build(frames[i][0], stamps[i], frames[i][1])
        descs.append(fr.desc[fr.valid].numpy())
    descs = np.concatenate(descs)
    return tvoc.train(descs, k=10, L=4, seed=1), descs


def _kidnap(cfg, voc, frames, poses, port: bool = False, trace: list | None = None) -> dict:
    order = list(range(KIDNAP_AT)) + [None] * KIDNAP_BLANKS + list(range(KIDNAP_RESUME, N))
    blank = (np.zeros_like(frames[0][0]), np.zeros_like(frames[0][1]))
    seq = [frames[i] if i is not None else blank for i in order]
    stamps = 1000.0 + np.arange(len(order)) / 30.0
    if port:
        slam = _port_system(voc)
        states = []
        for (gray, depth), t in zip(seq, stamps):
            slam.track_rgbd(gray, depth, t)
            states.append(slam.tracking_state)
        slam.flush_gba()
    else:
        slam = system_mod.SLAMSystem(cfg, system_mod.Sensor.RGBD, vocabulary=voc)
        if trace is not None:
            _traced(slam.loop_closer, trace)
        states = _drive(slam, seq, stamps)
    shown = [j for j, i in enumerate(order) if i is not None]
    gt_ts, gt = stamps[shown], poses[[order[j] for j in shown]]
    lost = [j for j, (_, _, l) in enumerate(slam.tracker.trajectory) if l]
    after = KIDNAP_AT + KIDNAP_BLANKS
    fid = _np(slam.map.kf_frame_id)
    if port:
        ts, est = slam.keyframe_trajectory()
        kf_ate = float(traj_io.ate_rmse(gt_ts, gt, ts, np.linalg.inv(est)))
    else:
        kf_ate = _kf_ate(slam, gt_ts, gt)
    return dict(
        frames=len(order), lost_frames=lost,
        reloc_frame=next((j for j in range(after, len(order))
                          if states[j] == tracking_mod.OK), None),
        keyframes=slam.n_keyframes, points=slam.n_points, kf_ate_m=kf_ate,
        loops=len(slam.loop_closer.events),
        events=[(int(fid[e.query_kf]), int(fid[e.match_kf])) for e in slam.loop_closer.events],
        kf_frame_ids=fid[_np(slam.map.kf_valid)].tolist())


def _reuse(cfg, voc, frames, poses, stamps) -> dict:
    slam = system_mod.SLAMSystem(cfg, system_mod.Sensor.RGBD, vocabulary=voc)
    _drive(slam, frames, stamps)
    saved = dict(keyframes=slam.n_keyframes, points=slam.n_points,
                 n_pt_slots=int(slam.map.n_pt))
    with tempfile.TemporaryDirectory() as d:
        path = Path(d) / "map.npz"
        slam.save_map(path)
        size = path.stat().st_size
        reuse = system_mod.SLAMSystem(cfg, system_mod.Sensor.RGBD, vocabulary=voc,
                                      reuse_map_path=str(path))
    assert reuse.localization_only and reuse.tracker.state == tracking_mod.LOST
    states = _drive(reuse, frames, stamps)
    traj = reuse.tracker.trajectory
    ok = [j for j, (_, _, l) in enumerate(traj) if not l]
    est = np.linalg.inv(np.asarray([traj[j][1] for j in ok])) if ok else np.zeros((0, 4, 4))
    return dict(
        saved=saved, file_bytes=size,
        first_reloc_frame=next((j for j, s in enumerate(states) if s == tracking_mod.OK),
                               None),
        localized_frames=len(ok), lost_frames=[j for j, (_, _, l) in enumerate(traj) if l],
        ate_localized_m=float(traj_io.ate_rmse(stamps, poses, stamps[ok], est)),
        keyframes=reuse.n_keyframes, points=reuse.n_points,
        n_pt_slots=int(reuse.map.n_pt))


def _long_run(name: str, frames: int | None) -> dict:
    """tools/scale_endurance_torch.py's `name` workload through the JAX
    package, one pass from a fresh system, outcomes read every frame."""
    from orbslam_mapsave_tpu.optim import pose_graph
    from orbslam_mapsave_tpu.pipeline import gba as gba_mod
    from orbslam_mapsave_tpu.slammap import mapstate
    from orbslam_mapsave_tpu.vocab import vocabulary

    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import scale_endurance_torch as tool

    wl = tool.WORKLOADS[name]
    n = frames or wl.frames
    cfg = cfg_mod.SystemConfig()
    cfg.camera = cfg_mod.CameraConfig(fx=wl.fx, fy=wl.fx, cx=wl.width / 2, cy=wl.height / 2,
                                      width=wl.width, height=wl.height,
                                      bf=wl.fx * BASELINE, th_depth=wl.th_depth, fps=30)
    cfg.orb = cfg_mod.ORBConfig(n_features=wl.n_features, n_levels=4, scale_factor=1.5)
    cfg.max_keypoints, cfg.max_keyframes = wl.max_keypoints, wl.max_keyframes
    cfg.max_points = wl.max_points
    room = synthetic.BoxRoom(half_size=wl.room[0], seed=wl.room[1])

    def rendered(poses):
        out = []
        for T in poses:
            g, d = room.render(wl.K, T, wl.width, wl.height)
            out.append((np.clip(g, 0, 255).astype(np.uint8).astype(np.float32),
                        d.astype(np.float16).astype(np.float32)))
        return out

    t0 = time.time()
    gt = wl.poses(n)
    frames = rendered(gt)
    if name == "scale":
        idx = np.arange(0, wl.frames, tool.SCALE_VOC_STEP)
        voc_frames = rendered(wl.poses()[idx])
    else:
        idx = np.arange(0, tool.BENCH_FRAMES, tool.BENCH_VOC_STEP)
        voc_frames = rendered(tool.bench_poses()[idx])
    trainer = system_mod.SLAMSystem(cfg, system_mod.Sensor.RGBD, vocabulary=None,
                                    enable_loop_closing=False)
    descs = []
    for (g, d), i in zip(voc_frames, idx):
        fr = trainer.builder.build(jnp.asarray(g), tool.T0 + i / 30.0, jnp.asarray(d))
        descs.append(np.asarray(fr.desc)[np.asarray(fr.valid)])
    voc = vocabulary.train(np.concatenate(descs), k=10, L=4, seed=1)
    setup_s = time.time() - t0

    rec = _gba_bookkeeping(gba_mod, pose_graph)
    kinds: list = []
    for kind in ("points", "keyframes"):
        fn = getattr(mapstate, f"compact_{kind}")
        setattr(mapstate, f"compact_{kind}",
                lambda st, fn=fn, kind=kind: kinds.append(kind) or fn(st))
    slam = system_mod.SLAMSystem(cfg, system_mod.Sensor.RGBD, vocabulary=voc)
    lc = slam.loop_closer
    events: list = []
    correct = lc._correct_loop

    def noted(state, kf, match_kf, *a):
        fid = np.asarray(state.kf_frame_id)
        events.append(dict(query_frame=int(fid[kf]), match_frame=int(fid[match_kf]),
                           inliers=lc.events[-1].n_inliers))
        return correct(state, kf, match_kf, *a)

    lc._correct_loop = noted
    stamps = tool.T0 + np.arange(n) / 30.0
    t0 = time.time()
    _drive(slam, frames, stamps)
    valid = np.asarray(slam.map.kf_valid)
    ts = np.asarray(slam.map.kf_timestamp, np.float64)[valid] + slam.tracker.ts_epoch
    est = np.linalg.inv(np.asarray(slam.map.kf_pose)[valid])
    return dict(
        mode=name, frames=n, n_words=voc.n_words,
        caps=[cfg.max_keyframes, cfg.max_points, cfg.max_keypoints],
        lost_frames=[j for j, (_, _, l) in enumerate(slam.tracker.trajectory) if l],
        keyframes_live=slam.n_keyframes, kf_alloc_watermark=int(slam.tracker.n_kf_watermark),
        points_live=slam.n_points, kf_ate_m=float(traj_io.ate_rmse(stamps, gt, ts, est)),
        kf_ate_segments_m=tool.segment_ates(stamps, gt, ts, est), loops=len(events),
        events=events,
        gba_applied=rec["applied"], gba_aborted=rec["aborted"],
        gba_solvers=rec["gba_solvers"], essential_solvers=rec["essential_solvers"],
        point_compactions=kinds.count("points"), keyframe_compactions=kinds.count("keyframes"),
        ba_lanes_dropped=slam.tracker.ba_lanes_dropped + slam.mapper.ba_lane_stats()[0],
        ba_escalations=slam.tracker.ba_escalations,
        kf_frame_ids=np.asarray(slam.map.kf_frame_id)[valid].tolist(),
        setup_seconds=setup_s, seconds=time.time() - t0)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--no-mapping", action="store_true", help="tracking only")
    ap.add_argument("--loop", action="store_true",
                    help="bench.py's headline configuration: vocabulary + loop closing")
    ap.add_argument("--kidnap", action="store_true",
                    help="the headline configuration, lost on 3 blank frames and put "
                         "back at frame 100")
    ap.add_argument("--reuse", action="store_true",
                    help="the headline configuration's map saved, reloaded and "
                         "localized against")
    ap.add_argument("--mono", action="store_true",
                    help="tools/bench_mono.py's workload: the image alone, monocular, "
                         "with the vocabulary and loop closing")
    ap.add_argument("--stereo", action="store_true",
                    help="the stereo workload: left and right u8 images, SLAMSystem "
                         "(cfg, STEREO), the vocabulary and loop closing")
    ap.add_argument("--endurance", action="store_true",
                    help="tools/endurance.py's 1,200-frame workload (compaction, loops)")
    ap.add_argument("--scale", action="store_true",
                    help="the first --frames frames of tools/scale_endurance.py's workload")
    ap.add_argument("--frames", type=int, default=None,
                    help="with --scale / --endurance: frames of the trajectory to run "
                         "(default 1,700 / 1,200)")
    ap.add_argument("--default-caps", action="store_true",
                    help="with --loop or --stereo: SystemConfig's default capacities")
    ap.add_argument("--trace", action="store_true",
                    help="with --kidnap: print each loop detection and Sim3 read")
    ap.add_argument("--port", action="store_true",
                    help="with --kidnap: run the PyTorch port on the CPU instead")
    ap.add_argument("--jax-vocabulary", action="store_true",
                    help="with --port: hand the port the JAX package's vocabulary")
    ap.add_argument("--fetch-every", type=int, default=1,
                    help="tracker outcome cadence with --loop (JAX default 16)")
    ap.add_argument("--devices", type=int, default=1,
                    help="virtual CPU devices (set before JAX starts); past 1 the JAX "
                         "package's GBAJob and relocalizer take their multi-device "
                         "branches")
    args = ap.parse_args()
    if len(jax.devices()) != args.devices:
        raise SystemExit(f"asked for {args.devices} devices, JAX has {len(jax.devices())}")
    if args.endurance or args.scale:
        frames = args.frames or (1700 if args.scale else None)
        print(json.dumps(dict(devices=DEVICES,
                              **_long_run("scale" if args.scale else "endurance", frames))))
        return
    K = np.array([[520.0, 0, W / 2], [0, 520.0, H / 2], [0, 0, 1.0]])
    poses = synthetic.circle_trajectory(N, radius=0.55, revs=1.30)
    room = synthetic.BoxRoom(half_size=2.0, seed=11)
    cfg = _config(default_caps=args.default_caps)
    stamps = 1000.0 + np.arange(N) / 30.0
    t0 = time.time()
    frames = []
    for i in range(N):
        gray, depth = room.render(K, poses[i], W, H)
        frames.append((np.clip(gray, 0, 255).astype(np.uint8).astype(np.float32),
                       depth.astype(np.float16).astype(np.float32)))
    with_voc = args.loop or args.kidnap or args.reuse or args.mono or args.stereo
    voc = _vocabulary(cfg, frames, stamps) if with_voc else None
    if args.stereo:
        pairs = [(f[0], np.clip(room.render(K, right_twc(poses[i]), W, H)[0], 0, 255)
                  .astype(np.uint8).astype(np.float32)) for i, f in enumerate(frames)]
        res = _stereo(cfg, voc, pairs, poses, stamps)
        print(json.dumps(dict(devices=DEVICES, mode="stereo", n_words=voc.n_words, **res,
                              seconds=time.time() - t0)))
        return
    if args.mono:
        res = _mono(cfg, voc, frames, poses, stamps)
        print(json.dumps(dict(devices=DEVICES, mode="mono", n_words=voc.n_words, **res,
                              seconds=time.time() - t0)))
        return
    if args.kidnap and args.port:
        pvoc, pdescs = _port_vocabulary(frames, stamps, voc if args.jax_vocabulary else None)
        differing = None
        if pdescs is not None:  # which training descriptors the packages disagree on
            jdescs = _descriptors(cfg, frames, stamps)
            differing = (int(np.any(jdescs != pdescs, axis=1).sum())
                         if jdescs.shape == pdescs.shape else [jdescs.shape, pdescs.shape])
        trace: list = []
        from orbslam_mapsave_tpu_torch.pipeline import loop_closing as tlc

        init = tlc.LoopCloser.__init__

        def traced_init(lc, *a, **k):
            init(lc, *a, **k)
            _traced(lc, trace)

        tlc.LoopCloser.__init__ = traced_init
        res = _kidnap(None, pvoc, frames, poses, port=True)
        print(json.dumps(dict(devices=DEVICES, mode="kidnap", package="port",
                              n_words=pvoc.n_words,
                              jax_n_words=voc.n_words, jax_vocabulary=args.jax_vocabulary,
                              training_descriptors=len(pdescs) if pdescs is not None else None,
                              training_descriptors_differing=differing, **res, trace=trace,
                              seconds=time.time() - t0)))
        return
    if args.kidnap or args.reuse:
        trace = [] if args.trace else None
        res = (_kidnap(cfg, voc, frames, poses, trace=trace) if args.kidnap
               else _reuse(cfg, voc, frames, poses, stamps))
        extra = {} if trace is None else dict(trace=trace)
        print(json.dumps(dict(devices=DEVICES, mode="kidnap" if args.kidnap else "reuse",
                              n_words=voc.n_words, **res, **extra, seconds=time.time() - t0)))
        return
    slam = system_mod.SLAMSystem(cfg, system_mod.Sensor.RGBD, vocabulary=voc,
                                 enable_loop_closing=args.loop,
                                 enable_mapping=not args.no_mapping)
    rec = None
    if args.loop:
        slam.tracker.fetch_every = args.fetch_every
        from orbslam_mapsave_tpu.optim import pose_graph
        from orbslam_mapsave_tpu.pipeline import gba as gba_mod

        rec = _gba_bookkeeping(gba_mod, pose_graph)
    for i in range(N):
        slam.track_rgbd(frames[i][0], frames[i][1], stamps[i])
        if not args.loop:
            slam.tracker.flush()
    slam.tracker.flush()
    slam.flush_gba()
    traj = slam.tracker.trajectory
    valid = np.asarray(slam.map.kf_valid)
    extra = {}
    if args.loop:
        fid = np.asarray(slam.map.kf_frame_id)
        extra = dict(
            n_words=voc.n_words, fetch_every=args.fetch_every,
            caps=[cfg.max_keyframes, cfg.max_points, cfg.max_keypoints],
            gba_applied=rec["applied"], gba_aborted=rec["aborted"],
            gba_solvers=rec["gba_solvers"], essential_solvers=rec["essential_solvers"],
            loops=len(slam.loop_closer.events),
            events=[dict(query_kf=e.query_kf, match_kf=e.match_kf,
                         query_frame=int(fid[e.query_kf]), match_frame=int(fid[e.match_kf]),
                         inliers=e.n_inliers) for e in slam.loop_closer.events])
    print(json.dumps(dict(
        devices=DEVICES, mapping=not args.no_mapping, **extra, keyframes=slam.n_keyframes,
        points=slam.n_points,
        kf_ate_m=_kf_ate(slam, stamps, poses),
        lost=sum(l for _, _, l in traj),
        kf_frame_ids=np.asarray(slam.map.kf_frame_id)[valid].tolist(),
        ba_lanes_dropped=slam.tracker.ba_lanes_dropped, seconds=time.time() - t0)))


if __name__ == "__main__":
    main()
