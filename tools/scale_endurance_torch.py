"""Long runs of the PyTorch port on one CUDA card, through
`SLAMSystem.track_rgbd`: the reference-scale workload of
tools/scale_endurance.py and the long run of tools/endurance.py.

    python tools/scale_endurance_torch.py [--workload scale|endurance]
        [--frames N] [--out PATH] [--device cuda]

scale (the default) is tools/scale_endurance.py's configuration: 320x240,
fx 260, 1,000 ORB features, 4 levels, scale 1.5, max_keypoints 1,024,
max_keyframes 1,536, max_points 262,144, ThDepth 30 (bf 20.8), the
Lissajous sweep `sweep_trajectory(8000)` in BoxRoom(2.5, seed=3), and a
vocabulary trained from frames 0, 60, ..., 7,980 (k=10, L=4, seed=1). A run
of N frames takes the first N of the 8,000-frame sweep: a sweep built over
fewer frames would move the camera faster.

endurance is tools/endurance.py's: 640x480, 2,000 features, max_keypoints
2,048, max_keyframes 256, max_points 49,152 (the point allocator crosses
the 0.9 compaction trigger inside the run), ThDepth 50 (bf 41.6),
circle_trajectory(1200, radius=0.55, revs=2.6) in BoxRoom(2.0, seed=11), and
bench.py's vocabulary (frames 0, 12, ..., 228 of the bench circle).

The frames are rendered in a pool of 8 processes before anything is timed.
Then 24 frames run untimed, `reset()`, and one timed
pass with a device sync after every frame. The JSON written to PATH
(default docs/SCALE_torch.json or docs/ENDURANCE_torch.json) holds the
card's name and power limit, every field of docs/SCALE_r5.json, the point
and keyframe compactions apart, the mapping-step ms, the peak device memory
and the keyframe ATE per 1,000-frame segment. It is rewritten after every
1,000 frames with `"complete": false`, so a run cut by a time limit leaves
its prefix. `chip_smoke.py` imports the builders below; nothing here
imports JAX.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import dataclasses
import json
import multiprocessing
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from orbslam_mapsave_tpu_torch import config as cfg_mod  # noqa: E402
from orbslam_mapsave_tpu_torch.io import synthetic  # noqa: E402
from orbslam_mapsave_tpu_torch.io import trajectory as traj_io  # noqa: E402
from orbslam_mapsave_tpu_torch.optim import pose_graph  # noqa: E402
from orbslam_mapsave_tpu_torch.pipeline import gba as gba_mod  # noqa: E402
from orbslam_mapsave_tpu_torch.pipeline import system as system_mod  # noqa: E402
from orbslam_mapsave_tpu_torch.slammap import mapstate  # noqa: E402
from orbslam_mapsave_tpu_torch.vocab import vocabulary  # noqa: E402

T0 = 1000.0  # timestamp of frame 0; frames are 1/30 s apart
SEGMENT = 1000  # frames per kf-ATE segment and per checkpoint of the JSON
SCALE_FRAMES = 8000  # tools/scale_endurance.py's N_FRAMES: the sweep's length
SCALE_VOC_STEP = 60  # its vocabulary frames: 0, 60, ..., 7,980
BENCH_FRAMES, BENCH_VOC_STEP = 240, 12  # bench.py's sequence and vocabulary frames
BASELINE = 0.08  # m: bf = fx x 0.08 in both configurations
WARMUP = 24  # untimed frames before the timed pass
WORKERS = 8  # render processes


@dataclasses.dataclass(frozen=True)
class Workload:
    name: str
    width: int
    height: int
    fx: float
    n_features: int
    max_keypoints: int
    max_keyframes: int
    max_points: int
    th_depth: float
    room: tuple  # BoxRoom (half_size, seed)
    frames: int  # frames of the whole trajectory; a run takes a prefix

    @property
    def K(self) -> np.ndarray:
        return np.array([[self.fx, 0, self.width / 2], [0, self.fx, self.height / 2],
                         [0, 0, 1.0]])

    def poses(self, frames: int | None = None) -> np.ndarray:
        """Ground-truth Twc of the first `frames` frames of the trajectory."""
        if self.name == "scale":
            full = sweep_trajectory(self.frames)
        else:
            full = synthetic.circle_trajectory(self.frames, radius=0.55, revs=2.6)
        return full[:frames]


SCALE = Workload("scale", 320, 240, 260.0, 1000, 1024, 1536, 262144, 30.0, (2.5, 3),
                 SCALE_FRAMES)
ENDURANCE = Workload("endurance", 640, 480, 520.0, 2000, 2048, 256, 49152, 50.0,
                     (2.0, 11), 1200)
WORKLOADS = {w.name: w for w in (SCALE, ENDURANCE)}


def sweep_trajectory(n: int) -> np.ndarray:
    """tools/scale_endurance.py's camera path (`:52-78`): a volume-filling
    Lissajous wander with a slow independent yaw (22 turns over the run)
    and a small pitch; the pose at frame i depends on i / n."""
    poses = np.zeros((n, 4, 4))
    for i in range(n):
        u = i / n
        x = 1.55 * np.sin(2 * np.pi * 3.0 * u + 0.7)
        y = 1.15 * np.sin(2 * np.pi * 5.0 * u + 1.9)
        z = 1.55 * np.sin(2 * np.pi * 4.0 * u + 0.2)
        yaw = 2 * np.pi * 22.0 * u
        pitch = 0.18 * np.sin(2 * np.pi * 9.0 * u)
        cy, sy = np.cos(yaw), np.sin(yaw)
        cp, sp = np.cos(pitch), np.sin(pitch)
        Ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
        Rx = np.array([[1, 0, 0], [0, cp, -sp], [0, sp, cp]])
        T = np.eye(4)
        T[:3, :3] = Ry @ Rx
        T[:3, 3] = [x, y, z]
        poses[i] = T
    return poses


def bench_poses() -> np.ndarray:
    """bench.py's 240-frame circle, whose frames train its vocabulary."""
    return synthetic.circle_trajectory(BENCH_FRAMES, radius=0.55, revs=1.30)


_ROOMS: dict = {}


def _render_chunk(job: tuple) -> list:
    (half, seed), K, poses, width, height = job
    if (half, seed) not in _ROOMS:
        _ROOMS[(half, seed)] = synthetic.BoxRoom(half_size=half, seed=seed)
    room = _ROOMS[(half, seed)]
    out = []
    for Twc in poses:
        gray, depth = room.render(K, Twc, width, height)
        out.append((np.clip(gray, 0, 255).astype(np.uint8), depth.astype(np.float16)))
    return out


def render(wl: Workload, poses: np.ndarray, workers: int = 8) -> list:
    """(u8 image, f16 depth) of each pose in the workload's room, as the
    JAX tools store them; chunks of frames go to `workers` spawned processes, which
    end with the call. A spawned process imports the caller's main module,
    so that module must keep its work under `if __name__ == "__main__":`;
    a worker that dies fails the call."""
    jobs = [(wl.room, wl.K, poses[i:i + 20], wl.width, wl.height)
            for i in range(0, len(poses), 20)]
    if workers <= 1 or len(jobs) == 1:
        parts = [_render_chunk(j) for j in jobs]
    else:
        with concurrent.futures.ProcessPoolExecutor(
                min(workers, len(jobs)), mp_context=multiprocessing.get_context("spawn")) as ex:
            parts = list(ex.map(_render_chunk, jobs))
    return [f for part in parts for f in part]


def config(wl: Workload) -> cfg_mod.SystemConfig:
    cfg = cfg_mod.SystemConfig()
    cfg.camera = cfg_mod.CameraConfig(
        fx=wl.fx, fy=wl.fx, cx=wl.width / 2, cy=wl.height / 2, width=wl.width,
        height=wl.height, bf=wl.fx * BASELINE, th_depth=wl.th_depth, fps=30)
    cfg.orb = cfg_mod.ORBConfig(n_features=wl.n_features, n_levels=4, scale_factor=1.5)
    cfg.max_keypoints = wl.max_keypoints
    cfg.max_keyframes = wl.max_keyframes
    cfg.max_points = wl.max_points
    return cfg


def make_system(wl: Workload, voc, device) -> system_mod.SLAMSystem:
    """SLAMSystem(cfg, RGBD) of the workload, loop closing on when given a
    vocabulary."""
    return system_mod.SLAMSystem(config(wl), system_mod.Sensor.RGBD, vocabulary=voc,
                                 enable_loop_closing=voc is not None, device=device)


def vocabulary_frames(wl: Workload, workers: int = 8) -> list:
    """The frames the workload's vocabulary is trained from, as
    (u8 image, f16 depth, timestamp): every 60th frame of the 8,000-frame
    sweep (scale), or bench.py's frames 0, 12, ..., 228 (endurance)."""
    if wl.name == "scale":
        idx = np.arange(0, wl.frames, SCALE_VOC_STEP)
        frames = render(wl, wl.poses()[idx], workers)
    else:
        idx = np.arange(0, BENCH_FRAMES, BENCH_VOC_STEP)
        frames = render(wl, bench_poses()[idx], workers)
    return [(g, d, T0 + i / 30.0) for (g, d), i in zip(frames, idx)]


def train_vocabulary(builder, frames: list) -> vocabulary.Vocabulary:
    """k = 10, L = 4, seed 1 over the ORB descriptors that `builder` (the
    system's own FrameBuilder) extracts from `frames`."""
    descs = []
    for g, d, t in frames:
        fr = builder.build(g, t, d)
        descs.append(fr.desc[fr.valid].cpu().numpy())
    return vocabulary.train(np.concatenate(descs), k=10, L=4, seed=1)


def bow_rows_match_rebuild(slam) -> tuple[int, int]:
    """(live keyframes, those whose row in the loop closer's BoW store
    differs from the row computed anew from the keyframe's descriptors)."""
    lc, st = slam.loop_closer, slam.map
    live = torch.nonzero(st.kf_valid).flatten().tolist()
    m = lc.bow_store.word.shape[1]
    bad = 0
    for kf in live:
        out = lc.transform(st.kf_desc[kf], st.kf_kp_valid[kf])
        w, v = vocabulary.sparse_bow(out["word"], out["weight"], m)
        bad += not (torch.equal(w, lc.bow_store.word[kf])
                    and torch.equal(v, lc.bow_store.weight[kf]))
    return len(live), bad


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


@contextlib.contextmanager
def recording(slam):
    """Record, while the block runs: each mapping step's ms, each slot
    compaction (kind, ms of the `_maybe_compact` call that ran it), each
    loop event's query / match frame ids (read when it is corrected: a
    keyframe compaction renumbers the slots an event holds), the solver of
    each global-BA job and essential graph, and the LM iterations each
    essential graph ran (1: the solver's early exit fired; 20: it did
    not). Every timing is bracketed by
    device syncs. Yields the record."""
    dev = slam.device
    rec = dict(map_step_ms=[], compactions=[], events=[], gba_solvers=[],
               essential_solvers=[], essential_iterations=[])
    lc, mapper = slam.loop_closer, slam.mapper
    kinds: list = []
    originals = dict(points=mapstate.compact_points, keyframes=mapstate.compact_keyframes)

    def counted(kind):
        def run(state):
            kinds.append(kind)
            return originals[kind](state)
        return run

    maybe_compact = slam._maybe_compact

    def timed_compact():
        kinds.clear()
        _sync(dev)
        t0 = time.perf_counter()
        maybe_compact()
        _sync(dev)
        if kinds:
            rec["compactions"].append(dict(kinds=list(kinds),
                                           ms=1e3 * (time.perf_counter() - t0)))

    step = mapper._map_step

    def timed_step(*a):
        _sync(dev)
        t0 = time.perf_counter()
        out = step(*a)
        _sync(dev)
        rec["map_step_ms"].append(1e3 * (time.perf_counter() - t0))
        return out

    solve_graph = pose_graph.optimize_pose_graph
    job_init = gba_mod.GBAJob.__init__

    def recorded_graph(prob, *a, **k):
        rec["essential_solvers"].append(k.get("solver", "dense"))
        pose_graph.reset_iterations()
        out = solve_graph(prob, *a, **k)
        rec["essential_iterations"].append(pose_graph.iterations)
        return out

    def recorded_job(job, *a, **k):
        job_init(job, *a, **k)
        rec["gba_solvers"].append(job._solver)

    mapstate.compact_points = counted("points")
    mapstate.compact_keyframes = counted("keyframes")
    pose_graph.optimize_pose_graph = recorded_graph
    gba_mod.GBAJob.__init__ = recorded_job
    slam._maybe_compact = timed_compact
    mapper._map_step = timed_step
    if lc is not None:
        correct = lc._correct_loop

        def noted(state, kf, match_kf, *a):
            fid = state.kf_frame_id
            rec["events"].append(dict(query_frame=int(fid[kf]), match_frame=int(fid[match_kf]),
                                      inliers=lc.events[-1].n_inliers))
            return correct(state, kf, match_kf, *a)

        lc._correct_loop = noted
    try:
        yield rec
    finally:
        mapstate.compact_points = originals["points"]
        mapstate.compact_keyframes = originals["keyframes"]
        pose_graph.optimize_pose_graph = solve_graph
        gba_mod.GBAJob.__init__ = job_init
        del slam._maybe_compact, mapper._map_step
        if lc is not None:
            del lc._correct_loop


def stretches(frames: list) -> list:
    """[first, last] of each run of consecutive frame numbers."""
    out: list = []
    for f in frames:
        if out and f == out[-1][1] + 1:
            out[-1][1] = f
        else:
            out.append([f, f])
    return out


def segment_ates(stamps: np.ndarray, gt: np.ndarray, ts: np.ndarray, est_twc: np.ndarray
                 ) -> list:
    """Keyframe ATE (m) of each SEGMENT-frame stretch of the run, aligned
    on its own keyframes; None where a stretch holds fewer than 3."""
    out = []
    for s in range(0, len(stamps), SEGMENT):
        lo, hi = stamps[s], stamps[min(s + SEGMENT, len(stamps)) - 1]
        sel = (ts >= lo - 1e-3) & (ts <= hi + 1e-3)
        out.append(float(traj_io.ate_rmse(stamps, gt, ts[sel], est_twc[sel]))
                   if sel.sum() >= 3 else None)
    return out


def summary(slam, rec: dict, frame_ms: np.ndarray, wall: float, gt: np.ndarray) -> dict:
    """The run's numbers, with docs/SCALE_r5.json's field names."""
    n = len(frame_ms)
    stamps = T0 + np.arange(n) / 30.0
    ts, est = slam.keyframe_trajectory()
    est_twc = np.linalg.inv(est)
    lc, mapper = slam.loop_closer, slam.mapper
    kinds = [k for c in rec["compactions"] for k in c["kinds"]]
    lost = [i for i, (_, _, is_lost) in enumerate(slam.tracker.trajectory) if is_lost]
    maps = np.asarray(rec["map_step_ms"]) if rec["map_step_ms"] else np.zeros(1)
    return dict(
        frames=n, total_s=wall, fps=n / wall,
        p50_ms=float(np.percentile(frame_ms, 50)), p90_ms=float(np.percentile(frame_ms, 90)),
        p99_ms=float(np.percentile(frame_ms, 99)), max_ms=float(frame_ms.max()),
        slowest_frame=int(np.argmax(frame_ms)),
        n_stalls_over_1s=int((frame_ms > 1e3).sum()),
        keyframes_live=slam.n_keyframes, kf_alloc_watermark=int(slam.tracker.n_kf_watermark),
        points_live=slam.n_points,
        lost_frames=lost, lost_stretches=stretches(lost),
        loops=len(rec["events"]), events=rec["events"],
        gba_applied=lc.gba_applied if lc else 0, gba_aborted=lc.gba_aborted if lc else 0,
        gba_solvers=rec["gba_solvers"], essential_solvers=rec["essential_solvers"],
        essential_iterations=rec["essential_iterations"],
        gba_solver=", ".join(sorted(set(rec["gba_solvers"]))) or None,
        pose_graph_solver=", ".join(sorted(set(rec["essential_solvers"]))) or None,
        compactions=len(rec["compactions"]), point_compactions=kinds.count("points"),
        keyframe_compactions=kinds.count("keyframes"),
        compaction_ms=[c["ms"] for c in rec["compactions"]],
        kf_ate_m=float(traj_io.ate_rmse(stamps, gt[:n], ts, est_twc)),
        kf_ate_segments_m=segment_ates(stamps, gt[:n], ts, est_twc),
        ba_lanes_dropped=slam.tracker.ba_lanes_dropped + mapper.ba_lane_stats()[0],
        ba_escalations=slam.tracker.ba_escalations,
        map_steps=len(rec["map_step_ms"]), map_step_p50_ms=float(np.percentile(maps, 50)),
        map_step_p99_ms=float(np.percentile(maps, 99)),
        map_step_ms_total=float(np.sum(rec["map_step_ms"])))


def warm_up(slam, frames: list, n: int):
    """n frames untimed (the first kernels, cuBLAS / cuSOLVER handles and
    the allocator's blocks at this workload's shapes), then reset()."""
    for i in range(n):
        slam.track_rgbd(frames[i][0], frames[i][1], T0 + i / 30.0)
    slam.flush_gba()
    slam.reset()
    _sync(slam.device)


def drive(slam, frames: list, gt: np.ndarray, checkpoint=None) -> dict:
    """One timed pass over `frames` from the system's current state: a
    device sync after every frame, the pending loop-closing work flushed at
    the end inside the wall time. `checkpoint(partial summary)` is called
    after every SEGMENT frames. Returns the summary with the per-frame ms."""
    dev = slam.device
    n = len(frames)
    frame_ms = np.empty(n)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    with recording(slam) as rec:
        t_start = time.perf_counter()
        for i in range(n):
            t1 = time.perf_counter()
            pose = slam.track_rgbd(frames[i][0], frames[i][1], T0 + i / 30.0)
            _sync(dev)
            frame_ms[i] = 1e3 * (time.perf_counter() - t1)
            if pose.shape != (4, 4) or not np.isfinite(pose).all():
                raise AssertionError(f"frame {i}: bad pose {pose}")
            if checkpoint is not None and (i + 1) % SEGMENT == 0 and i + 1 < n:
                checkpoint(summary(slam, rec, frame_ms[:i + 1],
                                   time.perf_counter() - t_start, gt))
        slam.flush_gba()
        _sync(dev)
        wall = time.perf_counter() - t_start
    res = summary(slam, rec, frame_ms, wall, gt)
    if dev.type == "cuda":
        res["peak_memory_bytes"] = int(torch.cuda.max_memory_allocated(dev))
    res["frame_ms"] = frame_ms
    return res


def card_line() -> str:
    """`nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", choices=sorted(WORKLOADS), default="scale")
    ap.add_argument("--frames", type=int, default=None,
                    help="frames of the trajectory to run (default: all of it)")
    ap.add_argument("--out", type=Path, default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    wl = WORKLOADS[args.workload]
    n = args.frames or wl.frames
    out = args.out or ROOT / "docs" / f"{wl.name.upper()}_torch.json"
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("no CUDA card: pass --device cpu to run on the CPU", file=sys.stderr)
        return 1
    card = card_line() if dev.type == "cuda" else "cpu"
    head = dict(workload=wl.name, card=card, device=str(dev),
                torch=torch.__version__, caps=dict(K=wl.max_keyframes, P=wl.max_points,
                                                   N=wl.max_keypoints),
                width=wl.width, height=wl.height, trajectory_frames=wl.frames)
    print(json.dumps(head), flush=True)

    t0 = time.perf_counter()
    gt = wl.poses(n)
    frames = render(wl, gt, WORKERS)
    voc_frames = vocabulary_frames(wl, WORKERS)
    render_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    voc = train_vocabulary(make_system(wl, None, dev).builder, voc_frames)
    voc_s = time.perf_counter() - t0
    print(f"rendered {n} + {len(voc_frames)} frames in {render_s:.1f} s; vocabulary "
          f"{voc.n_words} words in {voc_s:.1f} s", flush=True)
    slam = make_system(wl, voc, dev)
    warm_up(slam, frames, WARMUP)

    def write(res: dict, complete: bool):
        doc = dict(head, complete=complete, render_s=render_s, vocabulary_s=voc_s,
                   n_words=voc.n_words, warmup_frames=WARMUP,
                   **{k: v for k, v in res.items() if k != "frame_ms"})
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(doc, indent=1) + "\n")
        print(json.dumps({k: v for k, v in doc.items() if k not in ("events",
                          "compaction_ms", "lost_frames")}), flush=True)

    res = drive(slam, frames, gt, checkpoint=lambda r: write(r, False))
    live, bad = bow_rows_match_rebuild(slam)
    res.update(bow_rows_checked=live, bow_rows_differing=bad)
    write(res, True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
