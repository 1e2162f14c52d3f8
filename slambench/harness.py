"""One run of one cell: set-up, the measured window, the check, one line.

    python slambench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell names a configuration and a traffic mix in BENCHMARK.json; each
is a file of its own here (`configs/<name>.json`, `traffic/<name>.json`);
the cell's own file `cells/<cell>.json` holds its warm-up, the frames its
traced run profiles, the host cores and threads it runs on, and the
limits of the numbers that decide `correct`;
each per-layer metric is read by `metrics/<metric>.py`. Adding any of them takes new files and new
entries in BENCHMARK.json, never an edit here.

Set-up (timed as `setup_s`, from the process's start): torch, the program,
its pose-LM kernel (built once into the program's `_build/`), the
configuration's vocabulary, the episodes of `--seed` rendered on the
card, the `SLAMSystem`, and a warm-up over the first frames of the last
of them. The window plays the episodes in turn, back to back, in closed
loop: each frame is offered when the previous call has returned and the
device is synced; each episode starts from `reset()` and ends with
`flush_gba()`. After the
window the episode in progress runs to its end, untimed, and every episode
the window touched is judged against the generator's exact poses
(`reference.py`).
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import importlib.util
import json
import math
import os
import sys
import time
from pathlib import Path

import numpy as np

import episode as episode_mod
import reference
import layertrace as trace_mod

HERE = Path(__file__).resolve().parent
PROGRAM = "orbslam_mapsave_tpu_torch"
BLOCKED = ("jax", "jaxlib", "flax", "orbslam_mapsave_tpu")


def process_age_s() -> float:
    """Seconds since this process started (Linux /proc), so that set-up
    counts the interpreter's own start."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def loaded_blocked() -> list[str]:
    """Loaded modules whose top-level name is a blocked one, compared whole
    (the program's name begins with the JAX package's)."""
    return sorted(n for n, m in list(sys.modules.items())
                  if m is not None and n.split(".")[0] in BLOCKED)


def finite(v):
    """v, or None where it is not a finite number (JSON has no inf)."""
    return v if v is None or math.isfinite(v) else None


def load_cell(bench: dict, workload: str, base: Path) -> dict:
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; BENCHMARK.json has {sorted(cells)}")
    w = cells[workload]
    cfg = json.loads((base / "configs" / f"{w['config']}.json").read_text())
    traffic = json.loads((base / "traffic" / f"{w['traffic']}.json").read_text())
    run = json.loads((base / "cells" / f"{workload}.json").read_text())
    e2e = [m for m in bench["end_to_end"] if workload in m.get("workloads", [workload])]
    layer = [m for m in bench["per_layer"] if workload in m.get("workloads", [workload])]
    return dict(workload=w, config=cfg, traffic=traffic, run=run, limits=run["limits"],
                end_to_end=e2e, per_layer=layer)


def use_checkout_caches():
    """Every cache of the program's toolchain inside the checkout, at a
    fixed path."""
    cache = HERE / ".cache"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ["USE_FLAX"] = "0"


def pin_host(host: dict):
    """Hold the run to the cell's host cores and threads, so that its load
    on the host is the same in every run: the listed cores this process
    may use, else as many of those it may use, first first."""
    allowed = sorted(os.sched_getaffinity(0))
    cpus = [c for c in host["cpus"] if c in allowed] or allowed[:len(host["cpus"])]
    os.sched_setaffinity(0, cpus)
    import torch

    torch.set_num_threads(host["threads"])
    return cpus


def load_reader(name: str):
    spec = importlib.util.spec_from_file_location(f"slambench_metric_{name}",
                                                  HERE / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def system_config(cfg: dict):
    from orbslam_mapsave_tpu_torch import config as cfg_mod

    sc = cfg_mod.SystemConfig()
    sc.camera = cfg_mod.CameraConfig(**cfg["camera"])
    sc.orb = cfg_mod.ORBConfig(**cfg["orb"])
    sc.max_keypoints = cfg["max_keypoints"]
    sc.max_keyframes = cfg["max_keyframes"]
    sc.max_points = cfg["max_points"]
    return sc


class Run:
    """What a run hands the per-layer readers: the spans, and the profile
    of the cell's stretch (None where there is none)."""

    def __init__(self, spans, profile):
        self.spans = spans
        self.profile = profile


class Player:
    """Feeds the episodes of `sources` (each a `render` entry) to the
    system in turn, one call per frame, and keeps each frame's answer; with
    `profile_at` it profiles that stretch of the first episode and keeps
    each pose-LM launch's inputs."""

    def __init__(self, slam, sensor: str, sources: list, sync, profile_at: tuple | None):
        self.slam, self.sources, self.sync = slam, sources, sync
        self.mono = sensor == "MONOCULAR"
        self.episodes: list[dict] = []
        self.src = -1  # the source of the episode in progress
        self.frames: list = []
        self.k = 0  # the next frame; past the last one starts an episode
        self.closed = True
        self.profile_at = profile_at  # (first, end) frame of the first episode
        self.profiler = None
        self.events = None
        self.lm_inputs: list = []

    def _new_episode(self):
        self.slam.reset()
        self.src = (self.src + 1) % len(self.sources)
        self.frames, _, _, self.stamps = self.sources[self.src]
        self.episodes.append(dict(answers=[], ms=[], in_window=[], keyframes=None,
                                  src=self.src))
        self.k = 0
        self.closed = False

    def end_episode(self):
        ep = self.episodes[-1]
        self.closed = True
        self.slam.flush_gba()
        self.sync()
        ep["keyframes"] = self.slam.keyframe_trajectory()
        lc = self.slam.loop_closer
        ep["loops"] = lc.gba_applied if lc is not None else 0

    def _stretch(self, start: bool):
        import torch

        from orbslam_mapsave_tpu_torch.optim import pose_opt_cuda

        if start:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self.profiler = torch.profiler.profile(activities=acts)
            self.profiler.__enter__()
            self._range = torch.profiler.record_function(trace_mod.STRETCH)
            self._range.__enter__()
            orig = self._lm = pose_opt_cuda.pose_optimization_cuda

            def kept(cam, pose0, obs, *a, **k):
                self.lm_inputs.append((obs.valid, obs.ur))
                return orig(cam, pose0, obs, *a, **k)

            pose_opt_cuda.pose_optimization_cuda = kept
        else:
            self.sync()
            self._range.__exit__(None, None, None)
            self.profiler.__exit__(None, None, None)
            pose_opt_cuda.pose_optimization_cuda = self._lm
            self.events = trace_mod.kineto_events(self.profiler)
            self.profiler = None

    def step(self, in_window: bool) -> float:
        """Offer the next frame; returns its milliseconds (call to sync)."""
        if self.k == len(self.frames):
            if not self.closed:
                self.end_episode()
            self._new_episode()
        k, ep = self.k, self.episodes[-1]
        pa = self.profile_at
        if pa is not None and len(self.episodes) == 1 and k == pa[0] and self.events is None:
            self._stretch(True)
        image, depth = self.frames[k]
        traj = self.slam.tracker.trajectory
        n0 = len(traj)
        t1 = time.perf_counter()
        if self.mono:
            pose = self.slam.track_monocular(image, self.stamps[k])
        else:
            pose = self.slam.track_rgbd(image, depth, self.stamps[k])
        self.sync()
        ms = 1e3 * (time.perf_counter() - t1)
        traj = self.slam.tracker.trajectory
        # an answer is the returned pose and the program's own lost flag;
        # a call that records no frame has given no answer (lost)
        lost = traj[-1][2] if len(traj) == n0 + 1 else True
        ep["answers"].append((np.asarray(pose, np.float64), bool(lost)))
        ep["ms"].append(ms)
        ep["in_window"].append(in_window)
        self.k += 1
        if self.profiler is not None and self.k == pa[1]:
            self._stretch(False)
        return ms

    def finish(self):
        """Run the episode in progress to its end, untimed, and close it."""
        while self.k < len(self.frames):
            self.step(False)
        if self.profiler is not None:
            self._stretch(False)
        if not self.closed:
            self.end_episode()


def check(cell: dict, episodes: list, sources: list, fps: float) -> tuple[bool, dict, list]:
    """Judge every episode the window touched against the exact poses of
    its source; returns (correct, the numbers compared with their limits,
    each episode's numbers)."""
    with_scale = cell["config"]["alignment"] == "Sim3"
    per_ep = [reference.episode_numbers(ep["answers"], ep["keyframes"],
                                        sources[ep["src"]][1], sources[ep["src"]][2],
                                        with_scale, episode_mod.T0, fps)
              for ep in episodes]
    for e, ep in zip(per_ep, episodes):
        # the guarantee that each loop of the traffic is corrected: the loop
        # closer's count of corrections whose global BA was applied
        e["missed_loops"] = max(0, cell["traffic"]["loops"] - ep["loops"])
    checks = {}
    correct = bool(per_ep)
    for name, lim in cell["limits"].items():
        vals = [e[name] for e in per_ep if e[name] is not None]
        worst = max(vals) if vals else float("inf")
        ok = math.isfinite(worst) and worst <= lim["limit"]
        correct = correct and ok
        checks[name] = dict(value=worst, limit=lim["limit"])
    return correct, checks, per_ep


def prepare(cell: dict, device: str):
    """The set-up that no seed changes: the program and its pose-LM kernel,
    the configuration's vocabulary, the room and the `SLAMSystem`.
    Returns (system, room, sync)."""
    import torch

    from orbslam_mapsave_tpu_torch.pipeline import system as system_mod
    from orbslam_mapsave_tpu_torch.vocab import vocabulary

    cfg, traffic = cell["config"], cell["traffic"]
    on_card = device.startswith("cuda")
    if on_card:
        from orbslam_mapsave_tpu_torch.optim import pose_opt_cuda

        pose_opt_cuda.build()
    voc = (vocabulary.load_binary(HERE / cfg["vocabulary"])
           if cfg.get("vocabulary") else None)
    rc = traffic["room"]
    room = episode_mod.BoxRoom(rc["half_size"], rc["tex_size"], rc["seed"],
                               cache_dir=HERE / ".cache" / "rooms")
    slam = system_mod.SLAMSystem(system_config(cfg), system_mod.Sensor[cfg["sensor"]],
                                 vocabulary=voc, enable_loop_closing=cfg["loop_closing"],
                                 device=device)
    return slam, room, (torch.cuda.synchronize if on_card else (lambda: None))


def render(cell: dict, room, seed: int, device: str) -> list:
    """`seed`'s episodes in the order they are played: (frames, the exact
    Twc poses, the order, stamps) of each."""
    cam, traffic = cell["config"]["camera"], cell["traffic"]
    out = []
    for start in episode_mod.start_angles(traffic, seed):
        gt_wc, order = episode_mod.episode_poses(traffic, start)
        frames = episode_mod.episode_frames(room, cam, gt_wc, order, device)
        out.append((frames, gt_wc, order,
                    episode_mod.T0 + np.arange(len(order)) / float(cam["fps"])))
    return out


def warm_up(cell: dict, slam, sources: list, sync):
    """The first frames of the last episode, through what a long-running
    process pays once (handles, lazy module loads, the allocator's blocks)."""
    n = cell["run"]["warmup_frames"]
    frames, gt_wc, order, stamps = sources[-1]
    warm = Player(slam, cell["config"]["sensor"], [(frames[:n], gt_wc, order, stamps)],
                  sync, None)
    for _ in range(n):
        warm.step(False)
    warm.finish()


def main(argv=None, *, base: Path = HERE, bench_file: Path | None = None,
         device: str | None = None, fault=None) -> int:
    """Run one cell once; returns the exit code. `device` None asks for the
    card and fails without one; tests pass "cpu". `fault`, for tests,
    is called with the system before the window to break it."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench_file = bench_file or Path.cwd() / "BENCHMARK.json"
    cell = load_cell(json.loads(bench_file.read_text()), args.workload, base)
    readers = {m["name"]: load_reader(m["name"]) for m in cell["per_layer"]} if args.trace else {}

    use_checkout_caches()
    pin_host(cell["run"]["host"])

    import torch

    chips = cell["workload"]["chips"]
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            print(f"needs {chips} CUDA device(s); found "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 2
        device = "cuda"
    on_card = device.startswith("cuda")

    slam, room, sync = prepare(cell, device)
    sources = render(cell, room, args.seed, device)
    warm_up(cell, slam, sources, sync)
    if fault is not None:
        fault(slam)
    player = Player(slam, cell["config"]["sensor"], sources, sync,
                    tuple(cell["run"]["profile_frames"]) if args.trace else None)
    spans = trace_mod.Spans()
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    sync()
    # no collection pauses in the window: what set-up made is frozen out of
    # the collector's reach, and cycles wait for the window's end
    gc.collect()
    gc.freeze()
    gc.disable()
    setup_s = process_age_s()

    ctx = (trace_mod.installed(PROGRAM, spans, sync) if args.trace
           else contextlib.nullcontext())
    ms = []
    with ctx:
        cpu0 = time.process_time()
        t0 = time.perf_counter()
        while True:
            ms.append(player.step(True))
            if time.perf_counter() - t0 >= args.seconds:
                break
        window_s = time.perf_counter() - t0
        cpu_s = time.process_time() - cpu0
    gc.enable()
    memory_peak = torch.cuda.max_memory_allocated() if on_card else 0
    player.finish()
    # the program's state is freed before the reference judges its answers
    player.slam = slam = None
    correct, checks, per_ep = check(cell, player.episodes, sources,
                                    float(cell["config"]["camera"]["fps"]))

    n = len(ms)
    # frames of the window called lost after the first tracked one of their
    # episode (the two-view bootstrap)
    failed = sum(1 for ep, num in zip(player.episodes, per_ep)
                 for k, (a, w) in enumerate(zip(ep["answers"], ep["in_window"]))
                 if w and a[1] and k > num["first_tracked"])
    dev_info = dict(platform="gpu" if on_card else device,
                    kind=torch.cuda.get_device_name(0) if on_card else device,
                    count=chips if on_card else 0, memory_peak_bytes=int(memory_peak))
    result = dict(correct=correct, attempted=n, failed=failed)
    if args.trace:
        profile = None
        if player.events is not None:
            profile = trace_mod.reduce(player.events)
            profile.pose_lm = [
                (int(v.shape[0]), int(v.shape[1]), int((v & (u < 0)).sum()),
                 int((v & (u >= 0)).sum())) for v, u in player.lm_inputs]
        run = Run(spans, profile)
        metrics = {}
        for m in cell["per_layer"]:
            v = readers[m["name"]](run)
            if v is not None:
                metrics[m["name"]] = dict(value=float(v), unit=m["unit"])
        if profile is not None:
            dev_info.update(busy_s=profile.busy_s, window_s=profile.window_s)
            result["breakdown"] = dict(device_ops=profile.device_ops(),
                                       idle_gaps=[list(g) for g in profile.gaps])
    else:
        times = np.asarray(ms)
        values = dict(
            frames_per_s=n / window_s,
            frame_ms_p50=float(np.percentile(times, 50)),
            frame_ms_p95=float(np.percentile(times, 95)),
            setup_s=setup_s)
        metrics = {m["name"]: dict(value=values[m["name"]], unit=m["unit"])
                   for m in cell["end_to_end"]}
    result.update(metrics=metrics, device=dev_info)
    result["checks"] = {k: {"value": finite(c["value"]), "limit": c["limit"]}
                        for k, c in checks.items()}
    blocked = loaded_blocked()
    if blocked:
        print(f"blocked modules were loaded: {blocked}", file=sys.stderr)
        return 3
    for i, (e, ep) in enumerate(zip(per_ep, player.episodes)):
        worst = int(np.argmax(ep["ms"]))
        print(f"episode {i} source {ep['src']} "
              + json.dumps({k: finite(v) for k, v in e.items()})
              + f" window_frames {sum(ep['in_window'])} p50_ms {np.median(ep['ms']):.2f}"
              f" sum_s {sum(ep['ms']) / 1e3:.2f} max_ms {ep['ms'][worst]:.1f}"
              f" at_frame {worst}", file=sys.stderr)
    # the host's share of a run's spread: the process's CPU seconds (all
    # its threads) in the window
    print(f"host process cpu_s {cpu_s:.2f} in window_s {window_s:.2f}", file=sys.stderr)
    for name, v in sorted(spans.ms.items()):
        print(f"span {name} calls {len(v)} first {[round(x, 1) for x in v[:4]]} "
              f"max {max(v):.1f} mean {sum(v) / len(v):.1f}", file=sys.stderr)
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0
