"""SO3 / SE3 Lie-group operations on torch tensors.

Port of `orbslam_mapsave_tpu/geometry/se3.py` (SO3, SE3, Sim3 and the TUM
quaternion conversions). Rotations are 3x3
matrices, transforms 4x4 homogeneous matrices, a Sim3 a 4x4 matrix with sR
in the rotation block (g2o::Sim3 layout); every function broadcasts over
leading batch dimensions and is Taylor-guarded near theta=0.
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
    # sqrt of the sum, as the JAX version's norm (its forward-mode
    # derivative at skew = 0 is NaN on both sides)
    sin_t = 0.5 * torch.sqrt(torch.sum(skew * skew, dim=-1))
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
    bottom[..., 0, 3].fill_(1.0)  # a device fill: no host copy, capturable
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


def _det3(M: torch.Tensor) -> torch.Tensor:
    """Closed-form determinant of (...,3,3)."""
    return (M[..., 0, 0] * (M[..., 1, 1] * M[..., 2, 2] - M[..., 1, 2] * M[..., 2, 1])
            - M[..., 0, 1] * (M[..., 1, 0] * M[..., 2, 2] - M[..., 1, 2] * M[..., 2, 0])
            + M[..., 0, 2] * (M[..., 1, 0] * M[..., 2, 1] - M[..., 1, 1] * M[..., 2, 0]))


def _cbrt(x: torch.Tensor) -> torch.Tensor:
    return torch.sign(x) * torch.abs(x) ** (1.0 / 3.0)


def sim3_orthonormalize(S: torch.Tensor, iters: int = 3) -> torch.Tensor:
    """Project the sR block of a (...,4,4) Sim3 back onto scale x SO(3):
    scale det(sR)^(1/3), rotation by the Newton polar iteration."""
    M = S[..., :3, :3]
    s = _cbrt(torch.clamp(_det3(M), min=1e-30))[..., None, None]
    R = M / s
    eye3 = _eye3(S)
    for _ in range(iters):
        R = R @ (1.5 * eye3 - 0.5 * R.transpose(-1, -2) @ R)
    return rt_to_mat(s * R, S[..., :3, 3])


def quat_to_rot(q: torch.Tensor) -> torch.Tensor:
    """Quaternion (...,4) (x,y,z,w, TUM order) -> rotation matrix (...,3,3)."""
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    n = x * x + y * y + z * z + w * w
    s = torch.where(n > 0, 2.0 / torch.where(n > 0, n, torch.ones_like(n)), torch.zeros_like(n))
    wx, wy, wz = s * w * x, s * w * y, s * w * z
    xx, xy, xz = s * x * x, s * x * y, s * x * z
    yy, yz, zz = s * y * y, s * y * z, s * z * z
    return torch.stack([
        torch.stack([1.0 - (yy + zz), xy - wz, xz + wy], dim=-1),
        torch.stack([xy + wz, 1.0 - (xx + zz), yz - wx], dim=-1),
        torch.stack([xz - wy, yz + wx, 1.0 - (xx + yy)], dim=-1),
    ], dim=-2)


def rot_to_quat(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> quaternion (x,y,z,w), w>=0, branch-free
    (Shepperd): the candidate built on the largest of (trace, m00, m11,
    m22), normalized."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    qw = torch.stack([1.0 + tr, 1.0 + m00 - m11 - m22, 1.0 - m00 + m11 - m22,
                      1.0 - m00 - m11 + m22], dim=-1)
    qw = torch.sqrt(torch.clamp(qw, min=1e-12)) * 0.5
    d = 4.0 * qw
    q0 = torch.stack([(m21 - m12) / d[..., 0], (m02 - m20) / d[..., 0],
                      (m10 - m01) / d[..., 0], qw[..., 0]], dim=-1)
    q1 = torch.stack([qw[..., 1], (m01 + m10) / d[..., 1], (m02 + m20) / d[..., 1],
                      (m21 - m12) / d[..., 1]], dim=-1)
    q2 = torch.stack([(m01 + m10) / d[..., 2], qw[..., 2], (m12 + m21) / d[..., 2],
                      (m02 - m20) / d[..., 2]], dim=-1)
    q3 = torch.stack([(m02 + m20) / d[..., 3], (m12 + m21) / d[..., 3], qw[..., 3],
                      (m10 - m01) / d[..., 3]], dim=-1)
    cases = torch.stack([q0, q1, q2, q3], dim=-2)  # (...,4 cases,4)
    # first maximum on ties, as jnp.argmax
    which = torch.argmax(torch.stack([tr, m00, m11, m22], dim=-1), dim=-1)
    q = torch.gather(cases, -2, which[..., None, None].expand(*which.shape, 1, 4))[..., 0, :]
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    return torch.where(q[..., 3:4] < 0, -q, q)

def sim3_make(s: torch.Tensor, R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Scale (...,), rotation (...,3,3), translation (...,3) -> (...,4,4)."""
    return rt_to_mat(s[..., None, None] * R, t)


def sim3_split(S: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(...,4,4) -> (s, R, t). Scale recovered as det(sR)^(1/3)."""
    sR = S[..., :3, :3]
    s = _cbrt(_det3(sR))
    return s, sR / s[..., None, None], S[..., :3, 3]


def sim3_inv(S: torch.Tensor) -> torch.Tensor:
    s, R, t = sim3_split(S)
    Rt = R.transpose(-1, -2)
    sinv = 1.0 / s
    return sim3_make(sinv, Rt, -(sinv[..., None] * (Rt @ t[..., None])[..., 0]))


def _sim3_wmat(w: torch.Tensor, sigma: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(s, W): the scale exp(sigma) and the matrix mapping nu to the
    translation (Strasdat's scale-drift-aware SLAM derivation, the math of
    g2o's `sim3.h`), with the sigma -> 0 and theta -> 0 limits."""
    theta2 = torch.sum(w * w, dim=-1)
    theta = torch.sqrt(torch.clamp(theta2, min=0.0))
    s = torch.exp(sigma)
    W = hat(w)
    W2 = W @ W
    one = torch.ones_like(sigma)
    small_theta = theta2 < _EPS
    small_sigma = torch.abs(sigma) < 1e-6
    safe_sigma = torch.where(small_sigma, one, sigma)
    safe_theta = torch.where(small_theta, one, theta)
    safe_theta2 = torch.where(small_theta, one, theta2)
    C = torch.where(small_sigma, 1.0 + sigma * 0.5, (s - 1.0) / safe_sigma)
    a = s * torch.sin(safe_theta)
    b = s * torch.cos(safe_theta)
    c = theta2 + sigma * sigma
    safe_c = torch.where(c < 1e-12, one, c)
    A_general = (a * sigma + (1.0 - b) * safe_theta) / (safe_theta * safe_c)
    B_general = (C - ((b - 1.0) * sigma + a * safe_theta) / safe_c) / safe_theta2
    A_sig0 = _cosc(theta2)
    B_sig0 = torch.where(small_theta, one / 6.0,
                         (safe_theta - torch.sin(safe_theta)) / (safe_theta2 * safe_theta))
    A_th0 = torch.where(small_sigma, one * 0.5,
                        ((sigma - 1.0) * s + 1.0) / (safe_sigma * safe_sigma))
    B_th0 = torch.where(small_sigma, one / 6.0,
                        (s * (0.5 * sigma * sigma - sigma + 1.0) - 1.0) / safe_sigma ** 3)
    A = torch.where(small_sigma, A_sig0, torch.where(small_theta, A_th0, A_general))
    B = torch.where(small_sigma, B_sig0, torch.where(small_theta, B_th0, B_general))
    Wmat = C[..., None, None] * _eye3(w) + A[..., None, None] * W + B[..., None, None] * W2
    return s, Wmat


def sim3_exp(xi: torch.Tensor) -> torch.Tensor:
    """sim3 tangent (...,7) [nu(3), omega(3), sigma] -> Sim3 (...,4,4)."""
    nu, w, sigma = xi[..., :3], xi[..., 3:6], xi[..., 6]
    s, Wmat = _sim3_wmat(w, sigma)
    return sim3_make(s, so3_exp(w), (Wmat @ nu[..., None])[..., 0])


def sim3_log(S: torch.Tensor) -> torch.Tensor:
    """Sim3 (...,4,4) -> tangent (...,7) [nu, omega, sigma]; inverse of
    sim3_exp (solves W nu = t)."""
    s, R, t = sim3_split(S)
    w = so3_log(R)
    sigma = torch.log(s)
    _, Wmat = _sim3_wmat(w, sigma)
    nu = torch.linalg.solve(Wmat, t[..., None])[..., 0]
    return torch.cat([nu, w, sigma[..., None]], dim=-1)


def sim3_transform_points(S: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply Sim3 (...,4,4) to points (...,N,3)."""
    return pts @ S[..., :3, :3].transpose(-1, -2) + S[..., None, :3, 3]
