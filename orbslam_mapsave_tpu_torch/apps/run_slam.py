"""Dataset-driven SLAM main: the reference's example executables as one CLI.

Port of `orbslam_mapsave_tpu/apps/run_slam.py` (`Examples/RGBD_LoadImages.cpp`,
`RGBDFast_LoadImages.cpp`, `Monocular_LoadImages.cpp`,
`Stereo_LoadImages.cpp`; a growing image directory with `--follow` stands in
for a live mono or RGB-D sensor):

    python -m orbslam_mapsave_tpu_torch.apps.run_slam --dataset /path/to/tum \\
        --sensor rgbd --camera-yaml ORB_RGBD640x480.yaml --vocabulary voc.bin \\
        --out traj.txt --kf-out kf.txt --save-map map.npz
    python -m orbslam_mapsave_tpu_torch.apps.run_slam ... --reuse-map map.npz

Honors the master Setting.yaml cascade (`Examples/Setting.yaml`: vocabulary
path, camera settings path, reuse-map flag and path, viewer flag). Runs on
the CUDA card unless `--device` names another (`--device cpu` runs the
plain PyTorch path). `--sensor mono` reads the TUM rgb.txt images alone;
`--sensor stereo` reads a KITTI-layout directory (image_0/ left, image_1/
right, times.txt). The viewer (`viz/`): `--viewer-dir DIR` (or `UseViewer:
1`) writes a frame overlay and a map PNG every 10 frames, `--html-view
FILE` writes an interactive HTML map view at the end, and `--html-live N`
rewrites that file every N new keyframes during the run. `--trace-dir DIR`
turns the program's tracer on (`utils/metrics`) and at exit writes
`DIR/metrics.json` (per-span calls, total and self ms, counters, host syncs
by span and by file:line) and `DIR/spans.json` (the spans as a Chrome
trace on the Unix-epoch clock of a `torch.profiler` trace).
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--settings", help="master Setting.yaml (reference format)")
    ap.add_argument("--camera-yaml", help="camera/ORB settings yaml")
    ap.add_argument("--dataset", help="TUM/KITTI/imagedir dataset root")
    ap.add_argument("--sensor", choices=["mono", "rgbd", "stereo"], default="rgbd")
    ap.add_argument("--vocabulary", help=".bin/.txt vocabulary path")
    ap.add_argument("--reuse-map", help="map file to load (localization-only reuse mode)")
    ap.add_argument("--save-map", help="map file to write at the end")
    ap.add_argument("--out", default="CameraTrajectory.txt")
    ap.add_argument("--kf-out", default="KeyFrameTrajectory.txt")
    ap.add_argument("--viewer-dir", help="write frame/map snapshots here")
    ap.add_argument("--html-view", help="write an interactive HTML map view here at the "
                                        "end (orbit/zoom/pan in any browser)")
    ap.add_argument("--html-live", type=int, default=0, metavar="N_KFS",
                    help="LIVE map window: rewrite --html-view every N new keyframes "
                         "during the run; the page auto-refreshes, so a browser pointed "
                         "at it approximates the reference's live viewer (costs one map "
                         "fetch per rewrite)")
    ap.add_argument("--max-frames", type=int, default=0)
    ap.add_argument("--follow", action="store_true",
                    help="treat --dataset as a GROWING directory (live-sensor stand-in): "
                         "poll for new frames, drop backlog, stop after --follow-timeout "
                         "idle seconds")
    ap.add_argument("--follow-timeout", type=float, default=5.0)
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default cuda; cpu runs the plain path)")
    ap.add_argument("--trace-dir", type=Path,
                    help="trace the run: write metrics.json and spans.json here at exit")
    args = ap.parse_args(argv)
    if args.trace_dir is None:
        return _run(args)
    from ..utils import metrics

    metrics.enable()
    try:
        return _run(args)
    finally:
        metrics.disable()
        args.trace_dir.mkdir(parents=True, exist_ok=True)
        metrics.dump(args.trace_dir / "metrics.json")
        metrics.export_chrome(args.trace_dir / "spans.json")
        print(f"trace written to {args.trace_dir}")


def _run(args):
    from .. import config as config_mod
    from ..io import dataset as dataset_mod
    from ..pipeline import system as system_mod

    cfg = (config_mod.load_master_settings(args.settings) if args.settings
           else config_mod.SystemConfig())
    if args.camera_yaml:
        config_mod.load_camera_settings(args.camera_yaml, cfg)
    if args.reuse_map:
        cfg.reuse_map, cfg.reuse_map_path = True, args.reuse_map
    if args.vocabulary:
        cfg.vocabulary_path = args.vocabulary
    dataset_root = args.dataset or cfg.load_image_path

    voc = None
    if cfg.vocabulary_path and Path(cfg.vocabulary_path).is_file():
        from ..vocab import vocabulary as voc_mod

        print(f"Loading vocabulary {cfg.vocabulary_path} ...")
        t0 = time.time()
        voc = voc_mod.load(cfg.vocabulary_path)
        print(f"Vocabulary loaded ({voc.n_words} words) in {time.time() - t0:.2f}s")

    sensor = {"mono": system_mod.Sensor.MONOCULAR, "stereo": system_mod.Sensor.STEREO,
              "rgbd": system_mod.Sensor.RGBD}[args.sensor]
    slam = system_mod.SLAMSystem(
        cfg, sensor, vocabulary=voc,
        reuse_map_path=cfg.reuse_map_path if cfg.reuse_map else None, device=args.device)
    viewer = None
    if args.viewer_dir or cfg.use_viewer or (args.html_live and args.html_view):
        from ..viz.viewer import Viewer

        viewer = Viewer(
            slam, cfg.viewer, args.viewer_dir or "viewer_out",
            # PNG snapshots only when a viewer dir was asked for
            every_n=10 if (args.viewer_dir or cfg.use_viewer) else 10**9,
            live_html=args.html_view if args.html_live else None,
            live_every_kfs=max(args.html_live, 1))

    def log(i, extra):
        state = ["WAIT", "INIT", "OK", "LOST"][slam.tracking_state]
        print(f"  frame {i}: {state} kfs={slam.n_keyframes} pts={slam.n_points} {extra}",
              file=sys.stderr)

    def track(gray, other, t):  # other: the depth map, or the right image for stereo
        if sensor == system_mod.Sensor.MONOCULAR:
            return slam.track_monocular(gray, t)
        if sensor == system_mod.Sensor.STEREO:
            return slam.track_stereo(gray, other, t)
        return slam.track_rgbd(gray, other, t)

    t_track = []
    if args.follow:
        if sensor == system_mod.Sensor.STEREO:
            raise SystemExit("--follow supports mono/rgbd directories")
        src = dataset_mod.FollowSource(
            dataset_root, depth_factor=cfg.camera.depth_map_factor,
            fps=cfg.camera.fps, idle_timeout=args.follow_timeout)
        print(f"Following {dataset_root} ({args.sensor}), idle timeout "
              f"{args.follow_timeout}s ...")
        for i, (t, gray, depth) in enumerate(src.frames()):
            t0 = time.perf_counter()
            pose = track(gray, depth, t)
            t_track.append(time.perf_counter() - t0)
            if viewer is not None:
                viewer.update(gray, slam.tracker.last_frame, pose)
            if i % 30 == 0:
                log(i, f"dropped={src.n_dropped}")
            if args.max_frames and src.n_seen >= args.max_frames:
                break
        print(f"follow ended: {src.n_seen} frames tracked, {src.n_dropped} dropped "
              "(backlog policy)")
    else:
        ds = dataset_mod.open_dataset(dataset_root, depth_factor=cfg.camera.depth_map_factor)
        n = len(ds) if not args.max_frames else min(len(ds), args.max_frames)
        print(f"Tracking {n} frames from {dataset_root} ({args.sensor}) ...")
        for i in range(n):
            t, gray, other = ds.stereo(i) if sensor == system_mod.Sensor.STEREO else ds[i]
            t0 = time.perf_counter()
            pose = track(gray, other, t)
            t_track.append(time.perf_counter() - t0)
            if viewer is not None:
                viewer.update(gray, slam.tracker.last_frame, pose)
            if i % 30 == 0:
                log(i, f"({1e3 * t_track[-1]:.0f} ms)")

    if t_track:
        med = float(np.median(t_track))
        print(f"median track time: {1e3 * med:.1f} ms ({1.0 / med:.1f} fps)")
    slam.save_camera_trajectory(args.out)
    slam.save_keyframe_trajectory(args.kf_out)
    print(f"trajectories saved to {args.out}, {args.kf_out}")
    if args.save_map:
        slam.save_map(args.save_map)
        print(f"map saved to {args.save_map}")
    if args.html_view:
        from ..viz import html_viewer, viewer as viewer_mod

        html_viewer.export_html(slam.map, args.html_view,
                                trajectory=viewer_mod.tracked_twc(slam.tracker.trajectory))
        print(f"interactive map view written to {args.html_view}")
    slam.shutdown()


if __name__ == "__main__":
    main()
