"""The loop slice of `chip_smoke.py` (phase 7's untimed warm-up pass and
its timed pass, bench.py's headline configuration) from a given checkout,
to compare two commits on one card in turns:

    python3 tools/chip_ab_loop.py ROOT LABEL

ROOT is the root of a checkout: this one, or another commit unpacked with
`git archive` into a directory that `.gitignore` lists. Prints one line,
`[ab] LABEL {frames/s, p50/p99/max ms, keyframes, points, kf ATE,
launches}`. Run parent, change, change, parent, one process each, in one
call on the card. The rendered sequence is kept in the temporary directory
between the runs (the renderer is the same in both checkouts).
"""

import json
import sys
import tempfile
from pathlib import Path

import numpy as np


def main():
    root = Path(sys.argv[1]).resolve()
    sys.path.insert(0, str(root))
    import torch

    import chip_smoke as cs

    if Path(cs.__file__).resolve().parent != root:
        raise SystemExit(f"imported {cs.__file__}, not {root}/chip_smoke.py")
    dev = torch.device("cuda", 0)
    cs.phase_build()
    cache = Path(tempfile.gettempdir()) / "chip_ab_loop_seq.npz"
    if cache.exists():
        z = np.load(cache)
        seq = (z["poses"], list(zip(z["gray"], z["depth"])))
    else:
        seq = cs.bench_sequence()
        np.savez(cache, poses=seq[0], gray=np.stack([f[0] for f in seq[1]]),
                 depth=np.stack([f[1] for f in seq[1]]))
    voc = cs.train_vocabulary(cs._bench_system(dev, True), seq)
    res = cs._run_slice(cs._bench_system(dev, True, vocabulary=voc), seq, "loop",
                        warmup=cs.N_FRAMES)
    print("[ab]", sys.argv[2], json.dumps({k: res[k] for k in (
        "fps", "p50_ms", "p99_ms", "max_ms", "keyframes", "points", "kf_ate_m",
        "launches")}), flush=True)


if __name__ == "__main__":
    main()
