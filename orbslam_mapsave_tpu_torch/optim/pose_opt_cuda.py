"""The pose-LM CUDA kernel (`csrc/pose_lm.cu`): build, bind, launch.

Replaces the Pallas TPU kernel `_pose_lm_kernel` /
`pose_optimization_pallas` (`orbslam_mapsave_tpu/optim/pose_opt_pallas.py`):
the whole motion-only pose optimization, 4 rounds x 10 LM iterations, in
one launch per problem.

What bounds it on the card is launch and latency, not bytes or FLOPs: 64 KB
of edge data at M = 2048 and about 80 block-wide barriers in a dependent
chain. The kernel keeps the whole schedule in one launch, stages the edges
once in shared memory, and reduces in a fixed order with warp shuffles, so
a run is bit-for-bit repeatable (see the source's header).

The library is compiled by `nvcc` for sm_90a from the repository's source at
first use into `orbslam_mapsave_tpu_torch/_build/` and loaded with ctypes.
Nothing here falls back: a build or launch failure raises. The plain
PyTorch version is `pose_opt.pose_optimization_ref`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

from ..geometry import projection, se3

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "pose_lm.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

launches = 0  # kernel launches since the last reset (main-path evidence)

_lib = None
_lock = threading.Lock()
_max_edges: dict[int, int] = {}  # per device: edges one block can stage


def reset_launches() -> None:
    global launches
    launches = 0


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cands = [shutil.which("nvcc")]
    if cuda_home:
        cands.append(str(Path(cuda_home) / "bin" / "nvcc"))
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if c and Path(c).exists():
            return c
    raise RuntimeError("nvcc not found: the pose-LM kernel is built from "
                       "csrc/pose_lm.cu with the CUDA toolkit (set CUDA_HOME)")


def build(verbose: bool = False) -> Path:
    """Compile `csrc/pose_lm.cu` into `_build/` (keyed by the source hash
    and flags) unless that library already exists; returns its path."""
    src = SOURCE.read_bytes()
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    out = BUILD_DIR / f"libpose_lm_{key}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
           "-o", str(tmp), str(SOURCE)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
    if verbose and res.stderr:
        print(res.stderr.strip())
    os.replace(tmp, out)
    return out


def _load():
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            f = lib.pose_lm_launch
            f.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                          ctypes.c_float, ctypes.c_float, ctypes.c_float,
                          ctypes.c_float, ctypes.c_float,
                          ctypes.c_int, ctypes.c_int, ctypes.c_int,
                          ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                          ctypes.c_void_p]
            f.restype = ctypes.c_int
            lib.pose_lm_max_edges.argtypes = [ctypes.c_int]
            lib.pose_lm_max_edges.restype = ctypes.c_int
            _lib = lib
    return _lib


def pack_edges(obs) -> torch.Tensor:
    """PoseObs with a leading batch dim -> (B, 8, M) f32 rows
    X Y Z U V UR IS2 VALID, contiguous."""
    f32 = torch.float32
    return torch.stack([
        obs.pt_w[..., 0], obs.pt_w[..., 1], obs.pt_w[..., 2],
        obs.uv[..., 0], obs.uv[..., 1], obs.ur,
        obs.inv_sigma2, obs.valid,
    ], dim=1).to(f32).contiguous()


def pose_lm_raw(cam: projection.Camera, data: torch.Tensor,
                pose12: torch.Tensor, n_rounds: int = 4, n_iters: int = 10):
    """Launch the kernel on (B,8,M) edge data and (B,12) poses.

    Returns (pose (B,16) f32 row-major 4x4, inlier (B,M) bool), both freshly
    allocated, on torch's current stream."""
    global launches
    if data.device.type != "cuda" or pose12.device != data.device:
        raise ValueError("pose_lm_raw needs CUDA tensors on one device")
    if data.dtype != torch.float32 or pose12.dtype != torch.float32:
        raise TypeError("pose_lm_raw takes float32 inputs")
    if data.dim() != 3 or data.shape[1] != 8 or pose12.shape != (data.shape[0], 12):
        raise ValueError(f"bad shapes: data {tuple(data.shape)}, "
                         f"pose {tuple(pose12.shape)}")
    if not (data.is_contiguous() and pose12.is_contiguous()):
        raise ValueError("pose_lm_raw needs contiguous inputs")
    B, _, M = data.shape
    lib = _load()
    dev = data.device.index or 0
    if dev not in _max_edges:
        _max_edges[dev] = lib.pose_lm_max_edges(dev)
    max_m = _max_edges[dev]
    if B < 1 or M < 1 or M > max_m:
        raise ValueError(f"need B >= 1 and 1 <= M <= {max_m}, got B={B} M={M}")
    pose_out = torch.empty((B, 16), dtype=torch.float32, device=data.device)
    inlier = torch.empty((B, M), dtype=torch.bool, device=data.device)
    stream = torch.cuda.current_stream(data.device).cuda_stream
    err = lib.pose_lm_launch(
        data.data_ptr(), pose12.data_ptr(), cam.fx, cam.fy, cam.cx, cam.cy,
        cam.bf, B, M, n_rounds, n_iters, pose_out.data_ptr(),
        inlier.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"pose_lm_kernel launch failed: CUDA error {err}")
    launches += 1
    return pose_out, inlier


def pose_optimization_cuda(cam: projection.Camera, pose0_cw: torch.Tensor,
                           obs, n_rounds: int = 4, n_iters: int = 10):
    """Batched device path for `pose_opt.pose_optimization`.

    pose0_cw (B,4,4), obs: PoseObs with a leading batch dim B. Returns
    (pose_cw (B,4,4) orthonormalized, inlier (B,M) bool, n_inliers (B,) i32).
    """
    data = pack_edges(obs)
    pose12 = pose0_cw[:, :3, :].reshape(-1, 12).to(torch.float32).contiguous()
    pose_out, inlier = pose_lm_raw(cam, data, pose12, n_rounds, n_iters)
    pose = se3.orthonormalize(pose_out.reshape(-1, 4, 4))
    return pose, inlier, torch.sum(inlier.to(torch.int32), dim=-1)
