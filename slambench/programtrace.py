"""The program's own spans and host-sync counts, read for a traced run.

The program records spans and counters inside itself when its tracer is
on (`orbslam_mapsave_tpu_torch.utils.metrics`): each span a record of its
name, parent, frame sequence number, start and end on `time.time_ns()`,
the clock the profiler stamps its host events on, and the host syncs
charged to it. Importing this module turns that tracer on; the harness
loads the per-layer readers, and with them this module, only for
`--trace 1`, so the timed runs never trace. The spans stay out of the
profiler: a `record_function` range would show on the device's timeline
and count as a kernel in `layertrace.reduce`.

What the readers get from here:

- `window(run)`: the records of the measured window. Its first episode
  starts at the last `system.reset` record before the profile's first
  `tracking.track` range (the profiled stretch lies inside that episode);
  it holds as many `system.frame` records from there as the window
  tracked frames (`tracking.track` calls of the window's spans).
- `idle(run)`: the profiled stretch's device-idle time, each idle
  nanosecond put down to the innermost program span open at that time,
  or to `OUTSIDE` (no program span open: the harness, the profiler).

A program without the tracer (or with no such spans) gives None, never an
error: every reader then returns None.
"""

from __future__ import annotations

import sys

try:
    from orbslam_mapsave_tpu_torch.utils import metrics as _metrics
except ImportError:  # pragma: no cover - a checkout without the program
    _metrics = None

TRACER = getattr(_metrics, "GLOBAL", None)
if not (hasattr(_metrics, "enable") and hasattr(TRACER, "records")):
    TRACER = None  # a program whose metrics module records no spans
else:
    _metrics.enable()

OUTSIDE = "outside the program"


class Window:
    """The window's records (number, name, parent, frame, start ns, end ns,
    syncs), by number, and its frame count."""

    def __init__(self, records: list, frames: int):
        self.records = records
        self.frames = frames
        self.by_no = {r[0]: r for r in records}

    def named(self, name: str) -> list:
        return [r for r in self.records if r[1] == name]

    def under(self, rec, names: tuple = (), prefixes: tuple = ()) -> bool:
        """Whether `rec` or one of its ancestors is named one of `names` or
        starts with one of `prefixes`."""
        while rec is not None:
            if rec[1] in names or rec[1].startswith(prefixes):
                return True
            rec = self.by_no.get(rec[2])
        return False

    def syncs(self, within, outside: tuple = ()) -> int:
        """Host syncs charged to records under a span named `within`, not
        under a span whose name starts with one of `outside`."""
        return sum(r[6] for r in self.records if r[6]
                   and self.under(r, names=(within,))
                   and not (outside and self.under(r, prefixes=outside)))


def _track_ranges(run) -> list:
    p = run.profile
    if p is None:
        return []
    return sorted(r for r in p.ranges if r[0] == "tracking.track")


def window(run) -> Window | None:
    """The measured window's records, or None where they cannot be found."""
    if TRACER is None:
        return None
    cached = getattr(run, "_program_window", False)
    if cached is not False:
        return cached
    win = None
    ranges = _track_ranges(run)
    n_frames = len(run.spans.ms.get("tracking.track", []))
    if ranges and n_frames:
        first = round(ranges[0][1] * 1e9)
        recs = TRACER.records()
        resets = [r[4] for r in recs if r[1] == "system.reset" and r[4] <= first]
        if resets:
            w0 = resets[-1]
            frames = sorted((r for r in recs if r[1] == "system.frame" and r[4] >= w0),
                            key=lambda r: r[4])[:n_frames]
            if frames:
                w1 = frames[-1][5]
                win = Window([r for r in recs if r[4] >= w0 and r[5] <= w1], len(frames))
    run._program_window = win
    return win


class Idle:
    """The profiled stretch's device-idle nanoseconds by innermost program
    span, the stretch's frames, and its longest idle gaps."""

    def __init__(self, by_span: dict, frames: int, total_ns: int, gaps: list):
        self.by_span = by_span
        self.frames = frames
        self.total_ns = total_ns
        self.gaps = gaps  # (ns, [(span, ns), ...] most first), longest first


def _innermost_segments(recs: list, a: int, b: int) -> list:
    """[(start, end, name)] covering [a, b): the innermost span of `recs`
    (which nest) open over each piece, OUTSIDE where none is."""
    segs = []
    stack: list = []
    cur = a

    def emit(upto):
        nonlocal cur
        upto = min(max(upto, a), b)
        if upto > cur:
            segs.append((cur, upto, stack[-1][1] if stack else OUTSIDE))
            cur = upto

    for r in sorted(recs, key=lambda r: (r[4], -r[5])):
        while stack and stack[-1][5] <= r[4]:
            emit(stack[-1][5])
            stack.pop()
        emit(r[4])
        stack.append(r)
    while stack:
        emit(stack[-1][5])
        stack.pop()
    emit(b)
    return segs


def idle(run) -> Idle | None:
    """Attribute the profiled stretch's idle device time (None without a
    device profile or program records)."""
    if TRACER is None:
        return None
    cached = getattr(run, "_program_idle", False)
    if cached is not False:
        return cached
    out = None
    p = run.profile
    ranges = _track_ranges(run)
    if p is not None and p.ops and ranges:
        recs = TRACER.records()
        first = round(ranges[0][1] * 1e9)
        # the stretch opens just before its first frame's `system.frame`
        frame0 = [r for r in recs if r[1] == "system.frame" and r[4] <= first <= r[5]]
        if frame0:
            a = frame0[-1][4]
            b = a + round(p.window_s * 1e9)
            busy = sorted((round(s * 1e9), round((s + d) * 1e9)) for _, _, s, d, _ in p.ops)
            idle_iv, end = [], a
            for s, e in busy:
                if s > end:
                    idle_iv.append((end, min(s, b)))
                end = max(end, e)
            if end < b:
                idle_iv.append((end, b))
            idle_iv = [(s, e) for s, e in idle_iv if e > s]
            segs = _innermost_segments([r for r in recs if r[5] > a and r[4] < b], a, b)
            by_span: dict[str, int] = {}
            gaps = []
            j = 0
            for s, e in idle_iv:
                while j < len(segs) and segs[j][1] <= s:
                    j += 1
                parts: dict[str, int] = {}
                k = j
                while k < len(segs) and segs[k][0] < e:
                    ns = min(e, segs[k][1]) - max(s, segs[k][0])
                    if ns > 0:
                        parts[segs[k][2]] = parts.get(segs[k][2], 0) + ns
                    k += 1
                for name, ns in parts.items():
                    by_span[name] = by_span.get(name, 0) + ns
                gaps.append((e - s, sorted(parts.items(), key=lambda kv: -kv[1])))
            gaps.sort(key=lambda g: -g[0])
            out = Idle(by_span, len(ranges), sum(e - s for s, e in idle_iv), gaps[:10])
            _report(run, out)
    run._program_idle = out
    return out


def _report(run, idle_: Idle) -> None:
    """Standard error: the stretch's idle time by innermost span and its
    longest gaps, the window's host syncs by site, the tracer's totals."""
    p = run.profile
    tot = idle_.total_ns or 1
    outside = idle_.by_span.get(OUTSIDE, 0)
    named = sum(idle_.by_span.values()) - outside
    print(f"programtrace idle_ms {idle_.total_ns / 1e6:.3f} of window_ms "
          f"{p.window_s * 1e3:.3f} (profile idle_ms {(p.window_s - p.busy_s) * 1e3:.3f}) "
          f"named_spans {100.0 * named / tot:.1f}% outside {100.0 * outside / tot:.1f}% "
          f"frames {idle_.frames}", file=sys.stderr)
    for name, ns in sorted(idle_.by_span.items(), key=lambda kv: -kv[1])[:16]:
        print(f"programtrace idle_by_span {name} {ns / 1e6:.3f} ms "
              f"{100.0 * ns / tot:.1f}%", file=sys.stderr)
    for ns, parts in idle_.gaps:
        print(f"programtrace gap_ms {ns / 1e6:.3f} " + " ".join(
            f"{n}:{v / 1e6:.3f}" for n, v in parts[:3]), file=sys.stderr)
    win = window(run)
    if win is not None:
        tot: dict[str, list] = {}
        child: dict[int, int] = {}
        for r in win.records:
            child[r[2]] = child.get(r[2], 0) + r[5] - r[4]
        for r in win.records:
            t = tot.setdefault(r[1], [0, 0, 0, 0])
            t[0] += 1
            t[1] += r[5] - r[4]
            t[2] += r[5] - r[4] - child.get(r[0], 0)
            t[3] += r[6]
        print(f"programtrace window_frames {win.frames}", file=sys.stderr)
        for name, (n, total, own, syncs) in sorted(tot.items(), key=lambda kv: -kv[1][1])[:32]:
            print(f"programtrace window_span {name} calls {n} total_ms {total / 1e6:.1f} "
                  f"self_ms {own / 1e6:.1f} syncs {syncs}", file=sys.stderr)
    s = TRACER.summary()
    frames = max(s["frames"], 1)
    print(f"programtrace host_syncs {s['host_syncs']['total']} over {s['frames']} frames "
          f"records {s['records']} dropped {s['dropped']}", file=sys.stderr)
    for site, n in list(s["host_syncs"]["by_site"].items())[:12]:
        print(f"programtrace sync_site {site} {n} {n / frames:.3f}/frame", file=sys.stderr)
    for name, n in sorted(s["host_syncs"]["by_span"].items(), key=lambda kv: -kv[1])[:12]:
        print(f"programtrace sync_span {name} {n} {n / frames:.3f}/frame", file=sys.stderr)
    for name, n in s["counters"].items():
        print(f"programtrace counter {name} {n}", file=sys.stderr)
