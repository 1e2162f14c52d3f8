"""The JAX package's numbers on the benchmark sequence, on the CPU, for
`chip_smoke.py` to hold the PyTorch port against (the port's card cannot
run JAX).

    JAX_PLATFORMS=cpu python tools/jax_cpu_bench_reference.py \
        [--no-mapping | --loop | --kidnap | --reuse]

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

`--reuse` runs the headline configuration over the 240 frames, saves the
map with its BoW rows (`save_map`), reloads it with
`SLAMSystem(..., reuse_map_path=...)` (localization only, starting LOST)
and runs the 240 frames again: the first relocalized frame, the localized
frames, the ATE of the localized frames' poses against the ground truth,
and the loaded and final keyframe / point counts.

Both read the tracker's outcomes every frame (`fetch_every = 1`).
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

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


def _config():
    cfg = cfg_mod.SystemConfig()
    cfg.camera = cfg_mod.CameraConfig(fx=520.0, fy=520.0, cx=W / 2, cy=H / 2, width=W,
                                      height=H, bf=520.0 * 0.08, th_depth=50.0, fps=30)
    cfg.orb = cfg_mod.ORBConfig(n_features=2000, n_levels=4, scale_factor=1.5)
    cfg.max_keypoints, cfg.max_keyframes, cfg.max_points = 2048, 64, 32768
    return cfg


def _vocabulary(cfg, frames, stamps):
    from orbslam_mapsave_tpu.vocab import vocabulary

    trainer = system_mod.SLAMSystem(cfg, system_mod.Sensor.RGBD, vocabulary=None,
                                    enable_loop_closing=False)
    descs = []
    for i in range(0, N, 12):
        fr = trainer.builder.build(jnp.asarray(frames[i][0]), stamps[i],
                                   jnp.asarray(frames[i][1]))
        descs.append(np.asarray(fr.desc)[np.asarray(fr.valid)])
    return vocabulary.train(np.concatenate(descs), k=10, L=4, seed=1)


def _kf_ate(slam, gt_ts, gt_poses) -> float:
    valid = np.asarray(slam.map.kf_valid)
    ts = np.asarray(slam.map.kf_timestamp, np.float64)[valid] + slam.tracker.ts_epoch
    est = np.asarray(slam.map.kf_pose)[valid]
    return float(traj_io.ate_rmse(gt_ts, gt_poses, ts, np.linalg.inv(est)))


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


def _kidnap(cfg, voc, frames, poses) -> dict:
    order = list(range(KIDNAP_AT)) + [None] * KIDNAP_BLANKS + list(range(KIDNAP_RESUME, N))
    blank = (np.zeros_like(frames[0][0]), np.zeros_like(frames[0][1]))
    seq = [frames[i] if i is not None else blank for i in order]
    stamps = 1000.0 + np.arange(len(order)) / 30.0
    slam = system_mod.SLAMSystem(cfg, system_mod.Sensor.RGBD, vocabulary=voc)
    states = _drive(slam, seq, stamps)
    shown = [j for j, i in enumerate(order) if i is not None]
    gt_ts, gt = stamps[shown], poses[[order[j] for j in shown]]
    lost = [j for j, (_, _, l) in enumerate(slam.tracker.trajectory) if l]
    after = KIDNAP_AT + KIDNAP_BLANKS
    fid = np.asarray(slam.map.kf_frame_id)
    return dict(
        frames=len(order), lost_frames=lost,
        reloc_frame=next((j for j in range(after, len(order))
                          if states[j] == tracking_mod.OK), None),
        keyframes=slam.n_keyframes, points=slam.n_points, kf_ate_m=_kf_ate(slam, gt_ts, gt),
        loops=len(slam.loop_closer.events),
        events=[(int(fid[e.query_kf]), int(fid[e.match_kf])) for e in slam.loop_closer.events])


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
    ap.add_argument("--fetch-every", type=int, default=1,
                    help="tracker outcome cadence with --loop (JAX default 16)")
    args = ap.parse_args()
    K = np.array([[520.0, 0, W / 2], [0, 520.0, H / 2], [0, 0, 1.0]])
    poses = synthetic.circle_trajectory(N, radius=0.55, revs=1.30)
    room = synthetic.BoxRoom(half_size=2.0, seed=11)
    cfg = _config()
    stamps = 1000.0 + np.arange(N) / 30.0
    t0 = time.time()
    frames = []
    for i in range(N):
        gray, depth = room.render(K, poses[i], W, H)
        frames.append((np.clip(gray, 0, 255).astype(np.uint8).astype(np.float32),
                       depth.astype(np.float16).astype(np.float32)))
    with_voc = args.loop or args.kidnap or args.reuse
    voc = _vocabulary(cfg, frames, stamps) if with_voc else None
    if args.kidnap or args.reuse:
        res = (_kidnap(cfg, voc, frames, poses) if args.kidnap
               else _reuse(cfg, voc, frames, poses, stamps))
        print(json.dumps(dict(mode="kidnap" if args.kidnap else "reuse",
                              n_words=voc.n_words, **res, seconds=time.time() - t0)))
        return
    slam = system_mod.SLAMSystem(cfg, system_mod.Sensor.RGBD, vocabulary=voc,
                                 enable_loop_closing=args.loop,
                                 enable_mapping=not args.no_mapping)
    if args.loop:
        slam.tracker.fetch_every = args.fetch_every
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
            loops=len(slam.loop_closer.events),
            events=[dict(query_kf=e.query_kf, match_kf=e.match_kf,
                         query_frame=int(fid[e.query_kf]), match_frame=int(fid[e.match_kf]),
                         inliers=e.n_inliers) for e in slam.loop_closer.events])
    print(json.dumps(dict(
        mapping=not args.no_mapping, **extra, keyframes=slam.n_keyframes, points=slam.n_points,
        kf_ate_m=_kf_ate(slam, stamps, poses),
        lost=sum(l for _, _, l in traj),
        kf_frame_ids=np.asarray(slam.map.kf_frame_id)[valid].tolist(),
        ba_lanes_dropped=slam.tracker.ba_lanes_dropped, seconds=time.time() - t0)))


if __name__ == "__main__":
    main()
