"""Run one benchmark cell once and print its result as the last line.

    python3 slambench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

JAX and the JAX package are made unimportable before anything else loads:
the port's package name begins with the JAX package's, so every check
compares top-level module names whole.
"""

import sys
from pathlib import Path

for _name in ("jax", "jaxlib", "flax", "orbslam_mapsave_tpu"):
    sys.modules[_name] = None

sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(1, str(Path.cwd()))

import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main())
