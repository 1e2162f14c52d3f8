"""The JAX package's numbers on the benchmark sequence, on the CPU, for
`chip_smoke.py` to hold the PyTorch port against (the port's card cannot
run JAX).

    JAX_PLATFORMS=cpu python tools/jax_cpu_bench_reference.py [--no-mapping | --loop]

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
"""

from __future__ import annotations

import argparse
import json
import sys
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

N, W, H = 240, 640, 480


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--no-mapping", action="store_true", help="tracking only")
    ap.add_argument("--loop", action="store_true",
                    help="bench.py's headline configuration: vocabulary + loop closing")
    ap.add_argument("--fetch-every", type=int, default=1,
                    help="tracker outcome cadence with --loop (JAX default 16)")
    args = ap.parse_args()
    K = np.array([[520.0, 0, W / 2], [0, 520.0, H / 2], [0, 0, 1.0]])
    poses = synthetic.circle_trajectory(N, radius=0.55, revs=1.30)
    room = synthetic.BoxRoom(half_size=2.0, seed=11)
    cfg = cfg_mod.SystemConfig()
    cfg.camera = cfg_mod.CameraConfig(fx=520.0, fy=520.0, cx=W / 2, cy=H / 2, width=W,
                                      height=H, bf=520.0 * 0.08, th_depth=50.0, fps=30)
    cfg.orb = cfg_mod.ORBConfig(n_features=2000, n_levels=4, scale_factor=1.5)
    cfg.max_keypoints, cfg.max_keyframes, cfg.max_points = 2048, 64, 32768
    stamps = 1000.0 + np.arange(N) / 30.0
    t0 = time.time()
    frames = []
    for i in range(N):
        gray, depth = room.render(K, poses[i], W, H)
        frames.append((np.clip(gray, 0, 255).astype(np.uint8).astype(np.float32),
                       depth.astype(np.float16).astype(np.float32)))
    voc = None
    if args.loop:
        from orbslam_mapsave_tpu.vocab import vocabulary
        trainer = system_mod.SLAMSystem(cfg, system_mod.Sensor.RGBD, vocabulary=None,
                                        enable_loop_closing=False)
        descs = []
        for i in range(0, N, 12):
            fr = trainer.builder.build(jnp.asarray(frames[i][0]), stamps[i],
                                       jnp.asarray(frames[i][1]))
            descs.append(np.asarray(fr.desc)[np.asarray(fr.valid)])
        voc = vocabulary.train(np.concatenate(descs), k=10, L=4, seed=1)
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
    ts = np.asarray(slam.map.kf_timestamp, np.float64)[valid] + slam.tracker.ts_epoch
    est = np.asarray(slam.map.kf_pose)[valid]
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
        kf_ate_m=float(traj_io.ate_rmse(stamps, poses, ts, np.linalg.inv(est))),
        lost=sum(l for _, _, l in traj),
        kf_frame_ids=np.asarray(slam.map.kf_frame_id)[valid].tolist(),
        ba_lanes_dropped=slam.tracker.ba_lanes_dropped, seconds=time.time() - t0)))


if __name__ == "__main__":
    main()
