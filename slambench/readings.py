"""Read the numbers that decide a cell's `correct` over many seeds, in one
process, with the program as it is or with a control in its place.

    python3 slambench/readings.py --workload <cell> --seeds <n> [<n> ...]
        [--control <name>] [--dump <dir>]

Set-up is a run's: the program, the vocabulary, the system, the warm-up on
the first seed's last episode (then the control of `control.py`, if
named). Each of a seed's episodes then runs from `reset()`, one call per
frame as in the window, closes with `flush_gba()` and is judged by
`reference.py` against the cell's limits: one JSON line per episode. With
`--dump` each episode's answers, keyframes, exact poses and the loop
closer's running counts are written to
`<dir>/<cell>.<control>.<seed>.<source>.npz`. PERF.md gives the readings
each limit was set from. The benchmark's runs never run this.
"""

import argparse
import json
import sys
import time
from pathlib import Path

for _name in ("jax", "jaxlib", "flax", "orbslam_mapsave_tpu"):
    sys.modules[_name] = None

sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(1, str(Path.cwd()))

import numpy as np  # noqa: E402

import control  # noqa: E402
import harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", choices=sorted(control.CONTROLS))
    ap.add_argument("--dump", type=Path)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cell = harness.load_cell(json.loads((Path.cwd() / "BENCHMARK.json").read_text()),
                             args.workload, harness.HERE)
    harness.use_checkout_caches()
    harness.pin_host(cell["run"]["host"])
    slam, room, sync = harness.prepare(cell, args.device)
    harness.warm_up(cell, slam, harness.render(cell, room, args.seeds[0], args.device), sync)
    if args.control:
        control.CONTROLS[args.control](slam)
    fps = float(cell["config"]["camera"]["fps"])
    for seed in args.seeds:
        sources = harness.render(cell, room, seed, args.device)
        player = harness.Player(slam, cell["config"]["sensor"], sources, sync, None)
        for frames, gt, order, _ in sources:
            counts = []
            t0 = time.perf_counter()
            for _ in frames:
                player.step(True)
                lc = slam.loop_closer
                counts.append((len(lc.events), lc.gba_applied) if lc is not None else (0, 0))
            player.finish()
            seconds = time.perf_counter() - t0
            ep = player.episodes[-1]
            correct, checks, (num,) = harness.check(cell, [ep], sources, fps)
            print(json.dumps(dict(seed=seed, source=ep["src"], control=args.control,
                                  correct=correct, seconds=round(seconds, 2),
                                  **{k: harness.finite(v) for k, v in num.items()})),
                  flush=True)
            if args.dump:
                args.dump.mkdir(parents=True, exist_ok=True)
                ts, kf = ep["keyframes"]
                np.savez(args.dump / f"{args.workload}.{args.control}.{seed}.{ep['src']}.npz",
                         pose=np.stack([a[0] for a in ep["answers"]]),
                         lost=np.array([a[1] for a in ep["answers"]]), ms=np.array(ep["ms"]),
                         kf_ts=ts, kf_pose=kf, gt=gt, order=np.array(order),
                         loop_counts=np.array(counts))
    return 0


if __name__ == "__main__":
    sys.exit(main())
