"""orbslam_mapsave_tpu_torch — the PyTorch / CUDA port of orbslam_mapsave_tpu.

The JAX package beside this one is the reference implementation; every
module here mirrors the module of the same name there and is held against
it by the `tests/test_torch_*.py` parity tests. This package never imports
jax nor the JAX package.
"""

import torch as _torch

# Geometry and optimization need true float32 products: TF32 keeps ~3
# decimal digits, which breaks pose convergence and exact descriptor
# parity. The JAX package pins the same thing with
# `jax_default_matmul_precision="highest"`.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
