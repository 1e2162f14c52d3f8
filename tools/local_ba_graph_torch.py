"""Local BA on the card, on the windows the benchmark's RGB-D cell makes.

    python tools/local_ba_graph_torch.py [--frames 240] [--seed 3100001901]
        [--profile 3] [--out local_ba.json]

Tracks the first `--frames` frames of the first episode `--seed` renders
for `rgbd-room-loop` (its configuration, host cores and threads), keeping
every local BA's problem, and on each of them:

- the eager loop (`local_ba._run_phase` without static buffers): LM
  iterations, synced host ms of the call, of its wrapper alone (no LM
  iteration) and so of one iteration, and the host syncs of one call
  (`torch.cuda.set_sync_debug_mode("warn")`);
- where the program has it, the CUDA graph path (`local_ba._LMGraphs`):
  the same, its replays, and whether every `BAResult` field equals the
  eager one bit for bit; then, from empty caches, each capture's seconds
  and the bytes the pools reserve;
- on the first `--profile` problems, last (a profile slows later host
  work), the device ms of the call and of its wrapper from
  `torch.profiler`, and so the device ms of one LM iteration.

Prints a summary line per problem and one JSON line; with `--out`, also
writes the summary and every problem's row there. Runs on a tree without the graph path too (eager only). Needs the
card.
"""

import argparse
import json
import statistics
import sys
import time
import warnings
from pathlib import Path

for _name in ("jax", "jaxlib", "flax", "orbslam_mapsave_tpu"):
    sys.modules[_name] = None
ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "slambench"), str(ROOT)]

import harness  # noqa: E402
import layertrace  # noqa: E402

import torch  # noqa: E402
from orbslam_mapsave_tpu_torch.optim import local_ba  # noqa: E402
from orbslam_mapsave_tpu_torch.utils import metrics  # noqa: E402

GRAPHS = hasattr(local_ba, "_LMGraphs")


def windows(n_frames: int, seed: int) -> list:
    """(camera, problem, abort) of every local BA in the frames."""
    cell = harness.load_cell(json.loads((ROOT / "BENCHMARK.json").read_text()),
                             "rgbd-room-loop", harness.HERE)
    harness.use_checkout_caches()
    harness.pin_host(cell["run"]["host"])
    slam, room, sync = harness.prepare(cell, "cuda")
    imgs, _, _, stamps = harness.render(cell, room, seed, "cuda")[0]
    kept, solve = [], local_ba.local_bundle_adjustment

    def keep(cam, prob, *a, **k):
        kept.append((cam, local_ba.BAProblem(*[x.clone() for x in prob]),
                     bool(k.get("abort", False))))
        return solve(cam, prob, *a, **k)

    local_ba.local_bundle_adjustment = keep
    slam.reset()
    for k in range(n_frames):
        image, depth = imgs[k]
        slam.track_rgbd(image, depth, stamps[k])
    sync()
    local_ba.local_bundle_adjustment = solve
    return kept


def graph(cam, prob, abort: bool, n_a: int = 5, n_b: int = 10):
    """The program's local BA: the graph path where the tree has it."""
    return local_ba.local_bundle_adjustment(cam, prob, n_a, n_b, abort=abort)


def eager(cam, prob, abort: bool, n_a: int = 5, n_b: int = 10):
    """The eager loop on the card, as the parent runs it."""
    if not GRAPHS:
        return graph(cam, prob, abort, n_a, n_b)
    return local_ba._local_ba(cam, prob, local_ba._onehot_cam(prob), n_a, n_b, abort, None)


def synced_ms(fn, *args) -> tuple[float, object]:
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn(*args)
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t), out


def counted(attr_owner, name: str, fn, *args) -> tuple[int, object]:
    """Calls of attr_owner.name while fn runs."""
    orig = getattr(attr_owner, name)
    n = [0]

    def wrap(*a, **k):
        n[0] += 1
        return orig(*a, **k)

    setattr(attr_owner, name, wrap)
    try:
        out = fn(*args)
    finally:
        setattr(attr_owner, name, orig)
    return n[0], out


def syncs(fn, *args) -> int:
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn(*args)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return sum(metrics.SYNC_MESSAGE in str(x.message) for x in w)


def device_ms(fn, *args) -> tuple[float, int]:
    """Device ms of the kernels and copies fn launches, summed, and their
    number (profiler)."""
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn(*args)
        torch.cuda.synchronize()
    ops = [e for e in layertrace.kineto_events(prof) if e["device"] == "cuda" and e["kind"]]
    return sum(e["end"] - e["start"] for e in ops) / 1e3, len(ops)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=240)
    ap.add_argument("--seed", type=int, default=3100001901)
    ap.add_argument("--profile", type=int, default=3)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    probs = windows(args.frames, args.seed)
    rows = []
    for i, (cam, prob, abort) in enumerate(probs):
        r = dict(shape=[prob.cam_pose.shape[0]] + list(prob.obs_cam.shape), abort=abort)
        eager(cam, prob, abort)  # warm
        r["iters"], _ = counted(local_ba, "_build_and_solve", eager, cam, prob, abort)
        r["eager_ms"] = synced_ms(eager, cam, prob, abort)[0]
        r["wrapper_ms"] = synced_ms(eager, cam, prob, abort, 0, 0)[0]
        r["eager_syncs"] = syncs(eager, cam, prob, abort)
        if GRAPHS:
            want = eager(cam, prob, abort)
            r["replays"], got = counted(local_ba._LMGraphs, "_step", graph, cam, prob, abort)
            r["bit_identical"] = {n: bool(torch.equal(a, b))
                                  for n, a, b in zip(local_ba.BAResult._fields, got, want)}
            r["graph_ms"] = synced_ms(graph, cam, prob, abort)[0]
            r["graph_syncs"] = syncs(graph, cam, prob, abort)
        it = max(r["iters"], 1)
        r["host_ms_per_iter"] = (r["eager_ms"] - r["wrapper_ms"]) / it
        rows.append(r)
        print(f"problem {i} " + json.dumps(r), flush=True)
    out = dict(graphs=GRAPHS, frames=args.frames, seed=args.seed, n=len(rows),
               card=torch.cuda.get_device_name(0), torch=torch.__version__)
    for k in ("iters", "eager_ms", "wrapper_ms", "host_ms_per_iter", "eager_syncs",
              "replays", "graph_ms", "graph_syncs"):
        v = [r[k] for r in rows if k in r]
        if v:
            out[k] = dict(median=statistics.median(v), mean=statistics.fmean(v),
                          min=min(v), max=max(v))
    if GRAPHS:
        out["all_bit_identical"] = all(all(r["bit_identical"].values()) for r in rows)
        out["replays_equal_iters"] = all(r["replays"] == r["iters"] for r in rows)
        local_ba._GRAPHS.clear()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        cam, prob, abort = probs[0]
        reserved = torch.cuda.memory_reserved()
        first = synced_ms(graph, cam, prob, False)[0]
        out["pools_reserved_bytes"] = torch.cuda.memory_reserved() - reserved
        steady = synced_ms(graph, cam, prob, False)[0]
        out["first_call_ms"], out["steady_call_ms"] = first, steady
        out["capture_s_two_graphs"] = (first - steady) / 1e3
    prof = []
    for cam, prob, abort in probs[:args.profile]:
        (call, n_call), (wrap, n_wrap) = (device_ms(eager, cam, prob, abort),
                                          device_ms(eager, cam, prob, abort, 0, 0))
        it = counted(local_ba, "_build_and_solve", eager, cam, prob, abort)[0]
        p = dict(eager_device_ms=call, eager_ops=n_call, wrapper_device_ms=wrap,
                 wrapper_ops=n_wrap, iters=it, device_ms_per_iter=(call - wrap) / max(it, 1),
                 ops_per_iter=(n_call - n_wrap) / max(it, 1))
        if GRAPHS:
            p["graph_device_ms"], p["graph_ops"] = device_ms(graph, cam, prob, abort)
        prof.append(p)
        print("profile " + json.dumps(p), flush=True)
    out["profile"] = prof
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(dict(summary=out, rows=rows), indent=1))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
