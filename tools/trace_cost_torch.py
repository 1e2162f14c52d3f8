"""What the port's tracer (`utils/metrics.py`) costs on the card.

    python tools/trace_cost_torch.py [--frames 120] [--seed 3100001499]

- the disabled span at one site (`with metrics.span(...)`, a `traced`
  function, `count`), and the enabled span, in ns, from loops of 10^6;
- one host sync with the tracer on against off (`.item()` of a device
  scalar made by a line of the package, so the hook charges it);
- frames of `rgbd-room-loop` (the benchmark's cell: its configuration,
  the first `--frames` frames of the first episode `--seed` renders, its
  host cores and threads) tracked in blocks off, on, on, off, off, on, each
  from `reset()`, after an untimed warm-up block: median ms per frame, and
  spans and host syncs per frame from the tracer.

Prints one JSON line. Needs the card.
"""

import argparse
import gc
import json
import statistics
import sys
import time
from pathlib import Path

for _name in ("jax", "jaxlib", "flax", "orbslam_mapsave_tpu"):
    sys.modules[_name] = None
ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "slambench"), str(ROOT)]

import harness  # noqa: E402
from orbslam_mapsave_tpu_torch.utils import metrics  # noqa: E402

PKG_LINE = str(ROOT / "orbslam_mapsave_tpu_torch" / "pipeline" / "system.py")


def loop_ns(body: str, n: int, env: dict) -> float:
    """ns per iteration of `body` over n iterations, less an empty loop's."""
    code = compile(f"for _ in range({n}):\n    {body}", "<trace_cost>", "exec")
    empty = compile(f"for _ in range({n}):\n    pass", "<trace_cost>", "exec")
    best = []
    for c in (code, empty):
        runs = []
        for _ in range(5):
            t = time.perf_counter_ns()
            exec(c, env)
            runs.append(time.perf_counter_ns() - t)
        best.append(min(runs) / n)
    return best[0] - best[1]


def micro(n: int = 10**6) -> dict:
    def bare():
        pass

    env = dict(metrics=metrics, bare=bare, traced=metrics.traced("cost.fn")(bare))
    out = dict(off_span_ns=loop_ns("with metrics.span('cost.a'):\n        pass", n, env),
               off_traced_ns=loop_ns("traced()", n, env) - loop_ns("bare()", n, env),
               off_count_ns=loop_ns("metrics.count('cost.n')", n, env))
    metrics.reset()
    metrics.enable()
    out["on_span_ns"] = loop_ns("with metrics.span('cost.a'):\n        pass", n // 10, env)
    metrics.disable()
    metrics.reset()
    return out


def sync_cost(n: int = 2000) -> dict:
    import torch

    x = torch.ones((), device="cuda")
    # the same line as the package would run it, so the hook charges it
    code = compile(f"for _ in range({n}):\n    x.item()", PKG_LINE, "exec")
    times, counted = {}, []
    for on in (False, True, True, False):
        if on:
            metrics.reset()
            metrics.enable()
        with metrics.span("cost.sync"):
            t = time.perf_counter_ns()
            exec(code, dict(x=x))
            times.setdefault(on, []).append((time.perf_counter_ns() - t) / n)
        if on:
            counted.append(metrics.summary()["host_syncs"]["total"])
        metrics.disable()
    metrics.reset()
    return dict(item_off_ns=min(times[False]), item_on_ns=min(times[True]),
                hook_ns_per_sync=min(times[True]) - min(times[False]), counted=counted, n=n)


def frames(n_frames: int, seed: int) -> dict:
    import torch

    cell = harness.load_cell(json.loads((ROOT / "BENCHMARK.json").read_text()),
                             "rgbd-room-loop", harness.HERE)
    harness.use_checkout_caches()
    harness.pin_host(cell["run"]["host"])
    slam, room, sync = harness.prepare(cell, "cuda")
    imgs, _, _, stamps = harness.render(cell, room, seed, "cuda")[0]

    def block():
        slam.reset()
        ms = []
        for k in range(n_frames):
            image, depth = imgs[k]
            t = time.perf_counter()
            slam.track_rgbd(image, depth, stamps[k])
            sync()
            ms.append(1e3 * (time.perf_counter() - t))
        slam.flush_gba()
        sync()
        return ms

    block()  # warm-up
    gc.collect()
    gc.disable()
    res = {"off": [], "on": []}
    counts = []
    for on in (False, True, True, False, False, True):
        if on:
            metrics.reset()
            metrics.enable()
        ms = block()
        if on:
            s = metrics.summary()
            counts.append(dict(spans_per_frame=s["records"] / s["frames"],
                               syncs_per_frame=s["host_syncs"]["total"] / s["frames"],
                               frames=s["frames"]))
            metrics.disable()
        res["on" if on else "off"].append(ms)
    gc.enable()
    med = {k: [statistics.median(b) for b in v] for k, v in res.items()}
    mean = {k: [statistics.fmean(b) for b in v] for k, v in res.items()}
    return dict(frames=n_frames, seed=seed, median_ms=med, mean_ms=mean,
                on_cost_ms_median=statistics.fmean(med["on"]) - statistics.fmean(med["off"]),
                on_cost_ms_mean=statistics.fmean(mean["on"]) - statistics.fmean(mean["off"]),
                traced=counts, card=torch.cuda.get_device_name(0))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=120)
    ap.add_argument("--seed", type=int, default=3100001499)
    args = ap.parse_args()
    out = dict(micro=micro())
    out["frames"] = frames(args.frames, args.seed)
    out["sync"] = sync_cost()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
