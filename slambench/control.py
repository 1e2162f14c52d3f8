"""Run a cell with its control in the program's place, on the card.

    python3 slambench/control.py --workload <cell> --control <name> --seed <n> [--seconds s]

The control, the step that would tempt a change and which the check of
`correct` has to refuse (PERF.md gives its readings), breaks a guarantee
the configuration states, since the configuration states no precision:

- no_loop: loop correction skipped: the loop closer detects and computes
  its Sim3 (and keeps the BoW store relocalization reads), but corrects
  nothing.

Read beside it, and not refused: tf32, the program's float32 products in
TF32, the precision below the float32 it keeps them in.

And the faults a run must refuse, planted in the program:

- state_unchanged: the per-frame step returns the state it returned for
  the first frame after the warm-up, every frame after;
- answer_altered: every pose optimization's pose moved 5 cm along x where
  it is produced.

Each is applied after the warm-up, and the run goes on as the benchmark's
own; the last line is the harness's, with the numbers compared beside
their limits. The benchmark's runs never run a control.
"""

import argparse
import sys
from pathlib import Path

for _name in ("jax", "jaxlib", "flax", "orbslam_mapsave_tpu"):
    sys.modules[_name] = None

sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(1, str(Path.cwd()))

import harness  # noqa: E402


def tf32(slam):
    import torch

    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True


def no_loop(slam):
    slam.loop_closer._correct_loop = lambda state, *a: state


def state_unchanged(slam):
    step, first = slam.tracker.step, []

    def frozen(state, ctrl, frame):
        if not first:
            first.append(step(state, ctrl, frame))
        return first[0]

    slam.tracker.step = frozen


def answer_altered(slam):
    from orbslam_mapsave_tpu_torch.optim import pose_opt

    produce = pose_opt.pose_optimization

    def moved(*a, **k):
        pose, *rest = produce(*a, **k)
        pose = pose.clone()
        pose[..., 0, 3] += 0.05
        return (pose, *rest)

    pose_opt.pose_optimization = moved


CONTROLS = {"tf32": tf32, "no_loop": no_loop,
            "state_unchanged": state_unchanged, "answer_altered": answer_altered}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--control", required=True, choices=sorted(CONTROLS))
    args, rest = ap.parse_known_args()
    return harness.main(rest + ["--trace", "0"], fault=CONTROLS[args.control])


if __name__ == "__main__":
    sys.exit(main())
