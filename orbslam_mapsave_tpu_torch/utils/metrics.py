"""Structured metrics + per-stage timing (SURVEY.md §5.1/§5.5).

Port of `orbslam_mapsave_tpu/utils/metrics.py`. The reference's
observability is cout prose + chrono prints (`src/System.cc:156-194`,
`Examples/Monocular_LoadImages.cpp:112-124`). Here: a process-wide metrics
registry with counters, gauges and stage timers, dumpable as JSON;
`Metrics.stage` synchronizes the CUDA stream of the tensor it is handed
before it stops the clock, so device work is counted. `profiler_trace`
writes a `torch.profiler` Chrome trace.
"""

from __future__ import annotations

import contextlib
import json
import time
from collections import defaultdict
from pathlib import Path

import torch


class Metrics:
    def __init__(self):
        self.counters: dict[str, int] = defaultdict(int)
        self.gauges: dict[str, float] = {}
        self.stage_ms: dict[str, list[float]] = defaultdict(list)

    def count(self, name: str, n: int = 1) -> None:
        self.counters[name] += n

    def gauge(self, name: str, value: float) -> None:
        self.gauges[name] = float(value)

    @contextlib.contextmanager
    def stage(self, name: str, sync=None):
        """Time a stage; the CUDA stream of `sync` (a tensor, or a list or
        tuple of tensors) is synchronized before stopping the clock so
        device work is included."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            for t in (sync if isinstance(sync, (list, tuple)) else [sync]):
                if isinstance(t, torch.Tensor) and t.is_cuda:
                    torch.cuda.current_stream(t.device).synchronize()
            self.stage_ms[name].append(1e3 * (time.perf_counter() - t0))

    def summary(self) -> dict:
        import numpy as np

        stages = {
            k: {
                "n": len(v),
                "median_ms": float(np.median(v)),
                "p90_ms": float(np.percentile(v, 90)),
                "total_ms": float(np.sum(v)),
            }
            for k, v in self.stage_ms.items() if v
        }
        return {
            "counters": dict(self.counters),
            "gauges": self.gauges,
            "stages": stages,
        }

    def dump(self, path: str | Path) -> None:
        Path(path).write_text(json.dumps(self.summary(), indent=2))


GLOBAL = Metrics()


@contextlib.contextmanager
def profiler_trace(log_dir: str | Path):
    """Host and, where a card is present, device trace (`torch.profiler`),
    SURVEY §5.1, written as `log_dir/trace.json` (Chrome trace format).
    Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(str(log_dir / "trace.json"))
