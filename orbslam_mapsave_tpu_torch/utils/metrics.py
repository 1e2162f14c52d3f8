"""The port's tracer: spans and counters inside the program, off by default.

The reference's observability is cout prose and chrono prints
(`src/System.cc:156-194`, `Examples/Monocular_LoadImages.cpp:112-124`).
Here one process-wide registry, `GLOBAL`, records

- spans (`span(name)`, a context manager; `traced(name)`, its decorator
  form): name, parent span, frame sequence number, start and end from
  `time.time_ns()`, the clock a `torch.profiler` trace's host events are
  stamped on, so spans sit on the same axis as a profile of the run;
- counters (`count(name, n)`);
- host syncs: on the card, each synchronizing CUDA call the program makes
  while the tracer is on (`.item()`, `int()` / `bool()` of a device
  tensor, `.cpu()`, `nonzero`, boolean-mask indexing, a blocking copy from
  pageable host memory) is charged to the innermost open span and to the
  program's file:line that made it.

Off (the default), `span` returns one shared no-op context after a single
flag check: no clock reading, no allocation, no sync. On, each span is one
record in a ring of `RING` records; when it wraps, the oldest records are
dropped and counted, while the per-span totals of `summary()` keep every
call. Spans are opened and closed on one thread, as the pipeline runs.

Host syncs are caught with `torch.cuda.set_sync_debug_mode("warn")`, set
at the first span after `enable()` once CUDA is initialized and restored by
`disable()`: torch then raises a "called a synchronizing CUDA operation"
warning at each sync, which a `warnings` hook counts when the first frame
outside torch that made it lies in this package (the callers' own syncs,
a benchmark's `torch.cuda.synchronize()` among them, are not counted).

    from orbslam_mapsave_tpu_torch.utils import metrics
    metrics.enable()
    ...  # run frames
    metrics.dump("metrics.json")            # per-span calls / total / self ms,
    metrics.export_chrome("spans.json")     # counters, host syncs by span and site
"""

from __future__ import annotations

import functools
import json
import os
import sys
import time
import warnings
from pathlib import Path

RING = 1 << 17  # records kept; older ones are dropped (and counted)
SYNC_MESSAGE = "called a synchronizing CUDA operation"
OUTSIDE = "(no span)"  # syncs charged while no span was open

_PKG_DIR = str(Path(__file__).resolve().parents[1])
_PKG_ROOT = os.path.dirname(_PKG_DIR)
_on = False  # the flag every call site checks


class _NoSpan:
    """The shared context `span` returns while the tracer is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NOOP = _NoSpan()


class _Span:
    __slots__ = ("tracer", "name", "frame")

    def __init__(self, tracer, name: str, frame: bool):
        self.tracer, self.name, self.frame = tracer, name, frame

    def __enter__(self):
        self.tracer._open(self.name, self.frame)
        return self

    def __exit__(self, *exc):
        self.tracer._close()
        return False


class Tracer:
    """The registry: a ring of span records, per-span totals, counters and
    host syncs. A record is (number, name, parent number or -1, frame
    sequence number or -1, start ns, end ns, host syncs charged to it);
    it is written when its span closes."""

    def __init__(self, ring: int = RING):
        if ring & (ring - 1):
            raise ValueError(f"ring size {ring} is not a power of two")
        self._mask = ring - 1
        self._spans: dict[tuple[str, bool], _Span] = {}
        self._sync_mode = None  # the sync debug mode to restore; None: not set
        self._prev_showwarning = None
        self._sites: dict[str, tuple[str, str]] = {}  # filename -> _classify(filename)
        self.reset()

    def reset(self) -> None:
        """Drop every record, total, counter and sync count."""
        ring = self._mask + 1
        self._no = [-1] * ring
        self._name = [""] * ring
        self._parent = [-1] * ring
        self._frame = [-1] * ring
        self._t0 = [0] * ring
        self._t1 = [0] * ring
        self._syncs = [0] * ring
        self.n = 0  # records opened
        self.frame = -1  # sequence number of the newest frame span
        self._stack: list[list] = []  # open: [number, name, t0, child ns, syncs, frame]
        self.totals: dict[str, list[int]] = {}  # name -> [calls, total ns, self ns, syncs]
        self.counters: dict[str, int] = {}
        self.sync_sites: dict[str, int] = {}
        self.syncs_outside = 0

    @property
    def dropped(self) -> int:
        """Records the ring has dropped (overwritten by newer ones)."""
        return max(0, self.n - self._mask - 1)

    # -- spans -------------------------------------------------------------
    def span(self, name: str, frame: bool = False) -> _Span:
        key = (name, frame)
        s = self._spans.get(key)
        if s is None:
            s = self._spans[key] = _Span(self, name, frame)
        return s

    def _open(self, name: str, frame: bool) -> None:
        if self._sync_mode is None and self._prev_showwarning is not None:
            self._arm_sync_debug()
        if frame:
            self.frame += 1
        no = self.n
        self.n = no + 1
        self._stack.append([no, name, time.time_ns(), 0, 0, self.frame])

    def _close(self) -> None:
        t1 = time.time_ns()
        if not self._stack:  # reset() while the span was open
            return
        no, name, t0, child, syncs, frame = self._stack.pop()
        dur = t1 - t0
        parent = self._stack[-1] if self._stack else None
        if parent is not None:
            parent[3] += dur
        tot = self.totals.get(name)
        if tot is None:
            tot = self.totals[name] = [0, 0, 0, 0]
        tot[0] += 1
        tot[1] += dur
        tot[2] += dur - child
        tot[3] += syncs
        if no >= self.n - self._mask - 1:  # not yet overwritten
            i = no & self._mask
            self._no[i] = no
            self._name[i] = name
            self._parent[i] = parent[0] if parent is not None else -1
            self._frame[i] = frame
            self._t0[i] = t0
            self._t1[i] = t1
            self._syncs[i] = syncs

    def records(self) -> list[tuple]:
        """The closed records the ring holds, oldest first: (number, name,
        parent number, frame, start ns, end ns, host syncs)."""
        out = []
        for no in range(max(0, self.n - self._mask - 1), self.n):
            i = no & self._mask
            if self._no[i] == no:
                out.append((no, self._name[i], self._parent[i], self._frame[i],
                            self._t0[i], self._t1[i], self._syncs[i]))
        return out

    # -- host syncs --------------------------------------------------------
    def _arm_sync_debug(self) -> None:
        """Turn torch's sync warnings on once CUDA is in use (never
        initializes CUDA itself)."""
        torch = sys.modules.get("torch")
        if torch is None or not torch.cuda.is_initialized():
            return
        self._sync_mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("warn")

    def _site(self, filename: str, lineno: int) -> str | None:
        """The package's file:line that made a sync: the warning's own
        frame when it lies in this package; past torch's own Python frames
        (`torch.functional`, ...) the first frame outside torch; None when
        that frame lies outside the package."""
        kind = self._sites.get(filename)
        if kind is None:
            kind = self._sites[filename] = _classify(filename)
        if kind[0] == "pkg":
            return f"{kind[1]}:{lineno}"
        if kind[0] != "skip":
            return None
        f = sys._getframe(2)
        while f is not None:
            fn = f.f_code.co_filename
            k = self._sites.get(fn)
            if k is None:
                k = self._sites[fn] = _classify(fn)
            if k[0] == "pkg":
                return f"{k[1]}:{f.f_lineno}"
            if k[0] == "other":
                return None
            f = f.f_back
        return None

    def _charge_sync(self, site: str) -> None:
        """One host sync made at `site`, charged to the innermost open span."""
        if self._stack:
            self._stack[-1][4] += 1
        else:
            self.syncs_outside += 1
        self.sync_sites[site] = self.sync_sites.get(site, 0) + 1

    def _showwarning(self, message, category, filename, lineno, file=None, line=None):
        if str(message).startswith(SYNC_MESSAGE):
            if _on:
                site = self._site(filename, lineno)
                if site is not None:
                    self._charge_sync(site)
            return
        self._prev_showwarning(message, category, filename, lineno, file, line)

    def _install_hook(self) -> None:
        if self._prev_showwarning is not None:
            return
        self._prev_showwarning = warnings.showwarning
        warnings.showwarning = self._showwarning
        warnings.filterwarnings("always", message=SYNC_MESSAGE)

    def _remove_hook(self) -> None:
        if self._prev_showwarning is None:
            return
        if warnings.showwarning == self._showwarning:
            warnings.showwarning = self._prev_showwarning
        self._prev_showwarning = None
        warnings.filters[:] = [f for f in warnings.filters
                               if not (f[0] == "always" and f[1] is not None
                                       and f[1].pattern == SYNC_MESSAGE)]
        # the filters' version bump, as filterwarnings does it
        mutated = getattr(warnings, "_filters_mutated", None) or \
            getattr(warnings, "_filters_mutated_lock_held", None)
        if mutated is not None:
            mutated()
        if self._sync_mode is not None:
            import torch

            torch.cuda.set_sync_debug_mode(self._sync_mode)
            self._sync_mode = None

    # -- reports -----------------------------------------------------------
    def summary(self) -> dict:
        """Per span: calls, total and self ms and host syncs; the counters;
        host syncs in all, by span and by the package's file:line (most
        first); the frames seen and the records dropped."""
        spans = {name: dict(calls=c, total_ms=tot / 1e6, self_ms=own / 1e6, syncs=s)
                 for name, (c, tot, own, s) in sorted(self.totals.items())}
        by_span = {name: v["syncs"] for name, v in spans.items() if v["syncs"]}
        if self.syncs_outside:
            by_span[OUTSIDE] = self.syncs_outside
        return dict(
            spans=spans, counters=dict(sorted(self.counters.items())),
            host_syncs=dict(total=sum(self.sync_sites.values()), by_span=by_span,
                            by_site=dict(sorted(self.sync_sites.items(),
                                                key=lambda kv: (-kv[1], kv[0])))),
            frames=self.frame + 1, records=self.n, dropped=self.dropped)

    def dump(self, path: str | Path) -> None:
        Path(path).write_text(json.dumps(self.summary(), indent=2))

    def export_chrome(self, path: str | Path) -> None:
        """The ring's records as Chrome-trace complete ("X") events in
        microseconds since the Unix epoch, the axis of a `torch.profiler`
        trace's host events: open both in one viewer."""
        pid = os.getpid()
        events = [dict(name=name, ph="X", ts=t0 / 1e3, dur=(t1 - t0) / 1e3, pid=pid, tid=0,
                       args=dict(frame=frame, syncs=syncs, parent=parent, id=no))
                  for no, name, parent, frame, t0, t1, syncs in self.records()]
        Path(path).write_text(json.dumps(dict(traceEvents=events, displayTimeUnit="ms")))


def _classify(filename: str) -> tuple[str, str]:
    """("pkg", path from the repository root); ("skip", "") for torch's own
    Python and the warnings machinery, which lie between a sync and the
    code that asked for it; else ("other", "")."""
    path = os.path.abspath(filename)
    if path.startswith(_PKG_DIR + os.sep):
        return "pkg", os.path.relpath(path, _PKG_ROOT)
    torch = sys.modules.get("torch")
    if torch is not None and path.startswith(os.path.dirname(torch.__file__) + os.sep):
        return "skip", ""
    if path == os.path.abspath(warnings.__file__):
        return "skip", ""
    return "other", ""


GLOBAL = Tracer()


def span(name: str, frame: bool = False):
    """A span around a block: `with metrics.span("orb.pyramid"): ...`.
    `frame=True` starts a new frame sequence number (the system's per-frame
    entry points)."""
    if not _on:
        return NOOP
    return GLOBAL.span(name, frame)


def traced(name: str):
    """`span` as a decorator: every call of the function is one span."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if not _on:
                return fn(*args, **kwargs)
            with GLOBAL.span(name, False):
                return fn(*args, **kwargs)
        return wrapper
    return deco


def count(name: str, n: int = 1) -> None:
    """Add n to an integer counter."""
    if _on:
        GLOBAL.counters[name] = GLOBAL.counters.get(name, 0) + int(n)


def enable() -> None:
    """Turn the tracer on. Touches no CUDA and no torch setting: the sync
    debug mode is set at the first span once CUDA is in use."""
    global _on
    GLOBAL._install_hook()
    _on = True


def disable() -> None:
    """Turn the tracer off and restore the sync debug mode and warnings."""
    global _on
    _on = False
    GLOBAL._remove_hook()


def reset() -> None:
    GLOBAL.reset()


def summary() -> dict:
    return GLOBAL.summary()


def dump(path: str | Path) -> None:
    GLOBAL.dump(path)


def export_chrome(path: str | Path) -> None:
    GLOBAL.export_chrome(path)
