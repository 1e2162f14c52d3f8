"""SO3 / SE3 Lie-group operations on torch tensors.

Port of `orbslam_mapsave_tpu/geometry/se3.py` (the subset the RGB-D tracking
path uses). Rotations are 3x3 matrices, transforms 4x4 homogeneous
matrices; every function broadcasts over leading batch dimensions and is
Taylor-guarded near theta=0.
"""

from __future__ import annotations

import torch

_EPS = 1e-8


def _eye3(like: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=like.dtype, device=like.device)


def hat(w: torch.Tensor) -> torch.Tensor:
    """so3 hat operator: (...,3) -> (...,3,3) skew-symmetric matrix."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack(
        [
            torch.stack([z, -wz, wy], dim=-1),
            torch.stack([wz, z, -wx], dim=-1),
            torch.stack([-wy, wx, z], dim=-1),
        ],
        dim=-2,
    )


def vee(W: torch.Tensor) -> torch.Tensor:
    """Inverse of hat: (...,3,3) -> (...,3)."""
    return torch.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], dim=-1)


def _sinc(theta2: torch.Tensor) -> torch.Tensor:
    """sin(t)/t with Taylor guard, given t^2."""
    theta = torch.sqrt(torch.clamp(theta2, min=0.0))
    small = theta2 < _EPS
    safe = torch.where(small, torch.ones_like(theta), theta)
    return torch.where(small, 1.0 - theta2 / 6.0, torch.sin(safe) / safe)


def _cosc(theta2: torch.Tensor) -> torch.Tensor:
    """(1-cos(t))/t^2 with Taylor guard, given t^2."""
    small = theta2 < _EPS
    safe = torch.where(small, torch.ones_like(theta2), theta2)
    theta = torch.sqrt(torch.clamp(safe, min=0.0))
    return torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / safe)


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues: (...,3) axis-angle -> (...,3,3) rotation matrix."""
    theta2 = torch.sum(w * w, dim=-1)
    W = hat(w)
    W2 = W @ W
    A = _sinc(theta2)[..., None, None]
    B = _cosc(theta2)[..., None, None]
    return _eye3(w) + A * W + B * W2


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix (...,3,3) -> axis-angle (...,3); handles theta near 0
    (Taylor) and near pi (diagonal extraction)."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_t = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    skew = vee(R - R.transpose(-1, -2))
    sin_t = 0.5 * torch.linalg.vector_norm(skew, dim=-1)
    theta = torch.atan2(sin_t, cos_t)
    generic_scale = torch.where(
        theta < 1e-5,
        0.5 + theta * theta / 12.0,
        theta / torch.where(sin_t < 1e-10, torch.ones_like(sin_t), 2.0 * sin_t),
    )
    w_generic = generic_scale[..., None] * skew
    S = (R + _eye3(R)) * 0.5
    diag = torch.stack([S[..., 0, 0], S[..., 1, 1], S[..., 2, 2]], dim=-1)
    k = torch.argmax(diag, dim=-1)
    col = torch.take_along_dim(S, k[..., None, None].expand(S.shape[:-1] + (1,)),
                               dim=-1)[..., 0]
    axis = col / torch.linalg.vector_norm(col, dim=-1, keepdim=True).clamp(min=1e-12)
    dot = torch.sum(skew * axis, dim=-1, keepdim=True)
    axis = torch.where(dot < 0, -axis, axis)
    w_pi = theta[..., None] * axis
    use_generic = (sin_t > 1e-6) | (cos_t > 0.0)
    return torch.where(use_generic[..., None], w_generic, w_pi)


def so3_left_jacobian(w: torch.Tensor) -> torch.Tensor:
    """V matrix of SE3 exp: integral of exp(s*hat(w)) ds, (...,3)->(...,3,3)."""
    theta2 = torch.sum(w * w, dim=-1)
    W = hat(w)
    W2 = W @ W
    B = _cosc(theta2)[..., None, None]
    small = theta2 < _EPS
    safe2 = torch.where(small, torch.ones_like(theta2), theta2)
    theta = torch.sqrt(safe2)
    C = torch.where(small, 1.0 / 6.0 - theta2 / 120.0,
                    (theta - torch.sin(theta)) / (safe2 * theta))
    return _eye3(w) + B * W + C[..., None, None] * W2


def so3_left_jacobian_inv(w: torch.Tensor) -> torch.Tensor:
    """Inverse of the left Jacobian, analytic form."""
    theta2 = torch.sum(w * w, dim=-1)
    W = hat(w)
    W2 = W @ W
    small = theta2 < _EPS
    safe2 = torch.where(small, torch.ones_like(theta2), theta2)
    theta = torch.sqrt(safe2)
    half = theta * 0.5
    cot_coeff = torch.where(
        small,
        1.0 / 12.0 + theta2 / 720.0,
        (1.0 - half * torch.cos(half)
         / torch.sin(torch.where(small, torch.ones_like(half), half))) / safe2,
    )
    return _eye3(w) - 0.5 * W + cot_coeff[..., None, None] * W2


def rt_to_mat(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(...,3,3),(...,3) -> (...,4,4) homogeneous transform."""
    batch = torch.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    R = R.expand(batch + (3, 3))
    t = t.expand(batch + (3,))
    top = torch.cat([R, t[..., None]], dim=-1)
    bottom = torch.zeros(batch + (1, 4), dtype=R.dtype, device=R.device)
    bottom[..., 0, 3] = 1.0
    return torch.cat([top, bottom], dim=-2)


def mat_to_rt(T: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    return T[..., :3, :3], T[..., :3, 3]


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """se3 tangent (...,6) [upsilon(trans), omega(rot)] -> (...,4,4)."""
    v, w = xi[..., :3], xi[..., 3:6]
    R = so3_exp(w)
    V = so3_left_jacobian(w)
    t = (V @ v[..., None])[..., 0]
    return rt_to_mat(R, t)


def se3_log(T: torch.Tensor) -> torch.Tensor:
    """(...,4,4) -> (...,6) [upsilon, omega]."""
    R, t = mat_to_rt(T)
    w = so3_log(R)
    v = (so3_left_jacobian_inv(w) @ t[..., None])[..., 0]
    return torch.cat([v, w], dim=-1)


def orthonormalize(T: torch.Tensor, iters: int = 3) -> torch.Tensor:
    """Project the rotation block of (...,4,4) back onto SO(3) with the
    Newton polar iteration R <- R(3I - R^T R)/2 (see the JAX module for why
    the tracker needs it after every pose optimization)."""
    R = T[..., :3, :3]
    eye3 = _eye3(T)
    for _ in range(iters):
        R = R @ (1.5 * eye3 - 0.5 * R.transpose(-1, -2) @ R)
    return rt_to_mat(R, T[..., :3, 3])


def se3_inv(T: torch.Tensor) -> torch.Tensor:
    """Fast inverse of a rigid transform."""
    R, t = mat_to_rt(T)
    Rt = R.transpose(-1, -2)
    return rt_to_mat(Rt, -(Rt @ t[..., None])[..., 0])


def transform_points(T: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply (...,4,4) to points (...,N,3) -> (...,N,3)."""
    R, t = mat_to_rt(T)
    return pts @ R.transpose(-1, -2) + t[..., None, :]
