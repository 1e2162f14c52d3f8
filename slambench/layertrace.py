"""Spans around the program's layers, and the reduction of a profile.

Spans are set from here, around public calls into each layer, as class
attributes for the traced window only: each call is bracketed by device
syncs (so its host time is the layer's whole time) and runs inside a
`torch.profiler.record_function` range of the span's name, which the
profile reduction uses to attribute device kernels and idle gaps.

Nothing here imports the program at module level: `installed` imports the
classes it wraps by the program's package name.
"""

from __future__ import annotations

import collections
import contextlib
import time

# span name -> (module path under the program's package, class, method)
SPANS = {
    "tracking.track": [("pipeline.tracking", "Tracker", "track_rgbd"),
                       ("pipeline.tracking", "Tracker", "track_monocular")],
    "tracking.build": [("pipeline.frame", "FrameBuilder", "build")],
    "mapping.step": [("pipeline.local_mapping", "LocalMapper", "_map_step")],
    "loop.process": [("pipeline.loop_closing", "LoopCloser", "process")],
    "loop.poll_gba": [("pipeline.loop_closing", "LoopCloser", "poll_gba")],
    "reloc.relocalize": [("pipeline.relocalization", "Relocalizer", "relocalize")],
}
KERNEL_LAUNCH = {"cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                 "cuLaunchKernelEx", "cudaLaunchCooperativeKernel"}


class Spans:
    """Host milliseconds of every call of each span, synced."""

    def __init__(self):
        self.ms: dict[str, list[float]] = collections.defaultdict(list)

    def mean(self, name: str) -> float | None:
        v = self.ms.get(name)
        return sum(v) / len(v) if v else None


@contextlib.contextmanager
def installed(package: str, spans: Spans, sync):
    """Wrap each span's methods for the duration of the block."""
    import importlib

    import torch

    saved = []
    for name, targets in SPANS.items():
        for mod, cls_name, meth in targets:
            cls = getattr(importlib.import_module(f"{package}.{mod}"), cls_name)
            orig = cls.__dict__[meth]

            def wrapped(*a, _orig=orig, _name=name, **k):
                sync()
                t0 = time.perf_counter()
                with torch.profiler.record_function(_name):
                    out = _orig(*a, **k)
                    sync()
                spans.ms[_name].append(1e3 * (time.perf_counter() - t0))
                return out

            saved.append((cls, meth, orig))
            setattr(cls, meth, wrapped)
    try:
        yield spans
    finally:
        for cls, meth, orig in saved:
            setattr(cls, meth, orig)


class Profile:
    """What a profile of a stretch of frames reduces to: device kernels
    with their time and the spans open at their launch, idle gaps named by
    the span open when they began, and the stretch's length."""

    def __init__(self):
        # every device operation: name, kind, start, duration s, spans open
        # at its launch
        self.ops: list[tuple[str, str, float, float, tuple]] = []
        self.ranges: list[tuple[str, float, float]] = []  # span, start, end s (host)
        self.window_s = 0.0
        self.busy_s = 0.0
        self.gaps: list[tuple[str, float]] = []
        self.pose_lm: list[tuple[int, int, int]] = []  # per launch: problems, mono, stereo edges

    def calls(self, span: str) -> int:
        return sum(1 for r in self.ranges if r[0] == span)

    def kernels_in(self, span: str, outside: tuple = ()) -> int:
        """Kernels launched while `span` was open and no span of `outside` was."""
        return sum(1 for _, kind, _, _, open_ in self.ops if kind == "kernel"
                   and span in open_ and not any(o in open_ for o in outside))

    def kernel_times(self, fragment: str) -> list[float]:
        return [dur for name, kind, _, dur, _ in self.ops
                if kind == "kernel" and fragment in name]

    def device_ops(self, top: int = 10) -> list:
        tot = collections.Counter()
        for name, _, _, dur, _ in self.ops:
            tot[name] += dur
        return [[n, s] for n, s in tot.most_common(top)]


def _open_spans(ranges: list, t: float) -> tuple:
    return tuple(name for name, a, b in ranges if a <= t <= b)


STRETCH = "bench.stretch"  # the range around the profiled stretch of frames


def reduce(events: list[dict]) -> Profile:
    """Reduce the profiler's raw events (`kineto_events`) inside the
    STRETCH range: device operations, the spans open at each launch, the
    busy time and the longest idle gaps."""
    prof = Profile()
    stretch = [e for e in events if e["device"] == "cpu" and e["name"] == STRETCH]
    if not stretch:
        return prof
    t_start_us, t_end_us = stretch[0]["start"], stretch[0]["end"]
    prof.window_s = (t_end_us - t_start_us) * 1e-6
    launches = {}
    kernels = []
    for e in events:
        name, dev = e["name"], e["device"]
        if dev == "cpu" and name in SPANS:
            prof.ranges.append((name, e["start"] * 1e-6, e["end"] * 1e-6))
        elif dev == "cpu" and name in KERNEL_LAUNCH:
            launches[e["corr"]] = e["start"]
        elif dev == "cuda" and name not in SPANS and name != STRETCH:
            # (the profiler mirrors each host range onto the device's
            # timeline: those are annotations, not operations)
            kernels.append(e)
    prof.ranges.sort(key=lambda r: r[1])
    kernels.sort(key=lambda e: e["start"])
    busy_end = t_start_us
    busy = 0.0
    gaps = []
    for e in kernels:
        a, b = max(e["start"], t_start_us), min(e["end"], t_end_us)
        if b <= a:
            continue
        at = launches.get(e["corr"], e["start"])
        prof.ops.append((e["name"], e["kind"], a * 1e-6, (b - a) * 1e-6,
                         _open_spans(prof.ranges, at * 1e-6)))
        if a > busy_end:
            gaps.append((busy_end, a))
        busy += max(0.0, b - max(a, busy_end))
        busy_end = max(busy_end, b)
    if t_end_us > busy_end:
        gaps.append((busy_end, t_end_us))
    prof.busy_s = busy * 1e-6
    gaps.sort(key=lambda g: g[0] - g[1])
    for a, b in gaps[:10]:
        open_ = _open_spans(prof.ranges, a * 1e-6)
        prof.gaps.append((open_[-1] if open_ else "harness", (b - a) * 1e-6))
    return prof


def kineto_events(prof) -> list[dict]:
    """The profile's raw events as dicts: name, device ("cpu" / "cuda"),
    kind, start / end (us), correlation id."""
    out = []
    for e in prof.profiler.kineto_results.events():
        dev = "cuda" if "cuda" in str(e.device_type()).lower() else "cpu"
        start = e.start_ns() / 1e3
        kind = ""
        if dev == "cuda":
            n = e.name()
            kind = ("memcpy" if n.startswith("Memcpy") else
                    "memset" if n.startswith("Memset") else "kernel")
        out.append(dict(name=e.name(), device=dev, kind=kind, start=start,
                        end=start + e.duration_ns() / 1e3, corr=e.correlation_id()))
    return out
