"""The pose-LM CUDA kernel (`csrc/pose_lm.cu`): build, bind, launch.

Replaces the Pallas TPU kernel `_pose_lm_kernel` and the epilogue of
`pose_optimization_pallas` (`orbslam_mapsave_tpu/optim/pose_opt_pallas.py`):
the whole motion-only pose optimization, 4 rounds x 10 LM iterations, the
orthonormalization of the result, the inlier mask and the inlier count, in
one launch per call.

What bounds it on the card is the dependent chain of one problem on one SM,
not bytes: 40 LM iterations, each one edge pass, one block reduction and a
6x6 solve (see the source's header). The kernel reads the PoseObs tensors in
place, reduces in a fixed order with no atomics, so a run is bit-for-bit
repeatable.

The library is compiled by `nvcc` for sm_90a from the repository's source at
first use into `orbslam_mapsave_tpu_torch/_build/` and loaded with ctypes;
ptxas's register and spill report lands beside it. Nothing here falls back:
a build or launch failure raises. The plain PyTorch version is
`pose_opt.pose_optimization_ref`.
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

from ..geometry import projection

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "pose_lm.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

launches = 0  # kernel launches since the last reset (main-path evidence)
launches_batched = 0  # those of them with B > 1 (relocalization's candidates)

_lib = None
_lock = threading.Lock()
_max_edges: dict[int, int] = {}  # per device: edges one block can stage


def reset_launches() -> None:
    global launches, launches_batched
    launches = launches_batched = 0


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


def build() -> Path:
    """Compile the kernel into `_build/` (keyed by the source's hash and the
    flags) unless that library already exists; returns its path. ptxas's
    report (registers, shared memory, spills) is kept in
    `<library>.ptxas.txt`."""
    src = SOURCE.read_bytes()
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    out = BUILD_DIR / f"libpose_lm_{key}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    res = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
    out.with_suffix(".ptxas.txt").write_text(res.stdout + res.stderr)
    os.replace(tmp, out)
    return out


def _load():
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            ptr, f32, i32 = ctypes.c_void_p, ctypes.c_float, ctypes.c_int
            lib.pose_lm_launch.argtypes = [ptr] * 6 + [f32] * 5 + [i32] * 4 + [ptr] * 4
            lib.pose_lm_launch.restype = i32
            lib.pose_lm_init.argtypes = [i32]
            lib.pose_lm_init.restype = i32
            _lib = lib
    return _lib


def _max_edges_on(lib, dev: torch.device) -> int:
    """Opts the kernel into the device's largest dynamic shared memory, once
    per device; returns the edge count one block can stage."""
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    if idx not in _max_edges:
        with torch.cuda.device(idx):
            m = lib.pose_lm_init(idx)
        if m < 0:
            raise RuntimeError(f"pose_lm_init failed: CUDA error {-m}")
        _max_edges[idx] = m
    return _max_edges[idx]


def pose_optimization_cuda(cam: projection.Camera, pose0_cw: torch.Tensor,
                           obs, n_rounds: int = 4, n_iters: int = 10):
    """Batched device path for `pose_opt.pose_optimization`: one launch.

    pose0_cw (B,4,4) f32; obs: PoseObs with a leading batch dim B (pt_w
    (B,M,3), uv (B,M,2), ur and inv_sigma2 (B,M) f32, valid (B,M) bool), all
    on one CUDA device. Returns (pose_cw (B,4,4) orthonormalized, inlier
    (B,M) bool, n_inliers (B,) i32), freshly allocated, on torch's current
    stream."""
    global launches, launches_batched
    dev = pose0_cw.device
    tensors = (pose0_cw, *obs)
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError("pose_optimization_cuda needs CUDA tensors on one device")
    if any(t.dtype != torch.float32 for t in tensors[:-1]) or obs.valid.dtype != torch.bool:
        raise TypeError("pose_optimization_cuda takes float32 poses and edges "
                        "and a bool valid mask")
    B, M = obs.valid.shape if obs.valid.dim() == 2 else (0, 0)
    want = ((B, 4, 4), (B, M, 3), (B, M, 2), (B, M), (B, M), (B, M))
    if B < 1 or any(tuple(t.shape) != s for t, s in zip(tensors, want)):
        raise ValueError("bad shapes: " + ", ".join(str(tuple(t.shape)) for t in tensors))
    lib = _load()
    max_m = _max_edges_on(lib, dev)
    if not 1 <= M <= max_m or n_rounds < 1 or n_iters < 0:
        raise ValueError(f"need 1 <= M <= {max_m}, n_rounds >= 1, n_iters >= 0; "
                         f"got M={M} n_rounds={n_rounds} n_iters={n_iters}")
    pose0_cw, pt_w, uv, ur, is2, valid = (t.contiguous() for t in tensors)
    pose = torch.empty((B, 4, 4), dtype=torch.float32, device=dev)
    inlier = torch.empty((B, M), dtype=torch.bool, device=dev)
    n = torch.empty((B,), dtype=torch.int32, device=dev)
    err = lib.pose_lm_launch(
        pt_w.data_ptr(), uv.data_ptr(), ur.data_ptr(), is2.data_ptr(),
        valid.data_ptr(), pose0_cw.data_ptr(),
        cam.fx, cam.fy, cam.cx, cam.cy, cam.bf, B, M, n_rounds, n_iters,
        pose.data_ptr(), inlier.data_ptr(), n.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"pose_lm_kernel launch failed: CUDA error {err}")
    launches += 1
    launches_batched += int(B > 1)
    return pose, inlier, n
