"""Shared Levenberg-Marquardt pieces for the geometric optimizers.

Port of `orbslam_mapsave_tpu/optim/lm.py` (the subset pose optimization,
local BA and triangulation use). Conventions: poses are Tcw 4x4 matrices, tangent updates are LEFT
multiplicative T <- se3_exp(xi) @ T with xi = [v(3), w(3)], and the robust
loss is Huber applied as IRLS weights.
"""

from __future__ import annotations

import torch

# chi-square 95% gates (SURVEY.md appendix A)
CHI2_MONO = 5.991
CHI2_STEREO = 7.815


def huber_weight(chi2: torch.Tensor, delta2: torch.Tensor) -> torch.Tensor:
    """IRLS weight for the Huber kernel: 1 inside delta, delta/|e| outside."""
    r = torch.sqrt(torch.clamp(chi2, min=1e-20))
    d = torch.sqrt(delta2)
    return torch.where(chi2 <= delta2, torch.ones_like(r), d / r)


def proj_jacobian(p_cam: torch.Tensor, fx: float, fy: float) -> torch.Tensor:
    """d(pixel)/d(camera point): (...,2,3)."""
    x, y, z = p_cam[..., 0], p_cam[..., 1], p_cam[..., 2]
    zi = 1.0 / torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9), z)
    zi2 = zi * zi
    zero = torch.zeros_like(x)
    row0 = torch.stack([fx * zi, zero, -fx * x * zi2], dim=-1)
    row1 = torch.stack([zero, fy * zi, -fy * y * zi2], dim=-1)
    return torch.stack([row0, row1], dim=-2)


def point_pose_jacobian(p_cam: torch.Tensor) -> torch.Tensor:
    """d(camera point)/d(pose tangent [v,w]) for the left update: (...,3,6).
    dP/dv = I, dP/dw = -[P]x."""
    from ..geometry.se3 import hat

    eye = torch.eye(3, dtype=p_cam.dtype, device=p_cam.device).expand(
        p_cam.shape[:-1] + (3, 3))
    return torch.cat([eye, -hat(p_cam)], dim=-1)


def inv3x3(A: torch.Tensor) -> torch.Tensor:
    """Closed-form batched 3x3 inverse (adjugate / det); |det| < 1e-20 is
    clamped to 1e-20 as in the JAX version."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    A11 = e * i - f * h
    A12 = c * h - b * i
    A13 = b * f - c * e
    A21 = f * g - d * i
    A22 = a * i - c * g
    A23 = c * d - a * f
    A31 = d * h - e * g
    A32 = b * g - a * h
    A33 = a * e - b * d
    det = a * A11 + b * A21 + c * A31
    inv_det = 1.0 / torch.where(torch.abs(det) < 1e-20, torch.full_like(det, 1e-20), det)
    adj = torch.stack([
        torch.stack([A11, A12, A13], -1),
        torch.stack([A21, A22, A23], -1),
        torch.stack([A31, A32, A33], -1),
    ], -2)
    return adj * inv_det[..., None, None]


def jacobian_at_zero(f, n: int, batch: tuple, like: torch.Tensor):
    """Forward-mode Jacobian at x = 0 of f: x (*batch, n) -> a tensor or a
    tuple of tensors (*batch, ...), as `jax.jacfwd` gives it: the n unit
    directions ride one jvp on a leading axis. Returns (*batch, ..., n) per
    output. (`torch.func.jacfwd` over 0-dim slices promotes some tangents
    to float64; a batched primal keeps the dtype.)"""
    eye = torch.eye(n, dtype=like.dtype, device=like.device)
    tangent = eye.reshape((n,) + (1,) * len(batch) + (n,)).expand((n,) + batch + (n,))
    _, t = torch.func.jvp(f, (torch.zeros_like(tangent),), (tangent.contiguous(),))
    if isinstance(t, tuple):
        return tuple(torch.movedim(x, 0, -1) for x in t)
    return torch.movedim(t, 0, -1)


def solve_spd(H: torch.Tensor, g: torch.Tensor, lam,
              refine_steps: int = 2) -> torch.Tensor:
    """Solve (H + lam*I) dx = g in float32 with Jacobi pre-scaling and
    iterative refinement; a system that is not SPD (or any non-finite
    result) gives dx = 0, as the JAX version's NaN -> 0 rule does."""
    d = H.shape[-1]
    diag = torch.diagonal(H, dim1=-2, dim2=-1)
    s = 1.0 / torch.sqrt(torch.clamp(diag, min=1e-12))
    Hs = H * s[..., :, None] * s[..., None, :]
    Hs = Hs + lam * torch.eye(d, dtype=H.dtype, device=H.device)
    gs = g * s
    L, info = torch.linalg.cholesky_ex(Hs)
    y = torch.cholesky_solve(gs[..., None], L)[..., 0]
    for _ in range(refine_steps):
        r = gs - (Hs @ y[..., None])[..., 0]
        y = y + torch.cholesky_solve(r[..., None], L)[..., 0]
    dx = y * s
    ok = torch.isfinite(dx) & (info == 0)[..., None]
    return torch.where(ok, dx, torch.zeros_like(dx))


def _floor_abs(x: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.abs(x) < 1e-30, torch.full_like(x, 1e-30), x)


def pcg(matvec, apply_minv, rhs: torch.Tensor, iters: int, keep_going,
        safe_pAp=_floor_abs) -> torch.Tensor:
    """Preconditioned conjugate gradients from x = 0, the JAX solvers'
    `lax.while_loop(i < iters & keep_going(r))` with a fixed trip count:
    an iterate whose residual has stopped `keep_going` (a bool tensor) is
    frozen by `torch.where`, so the result equals the early exit. The loop
    also ends on the host once the test has turned false, read every 10th
    iteration on a card (a device sync) and every iteration on the CPU;
    this cuts work and leaves the result as it is. `safe_pAp` guards the
    step's denominator (the solvers differ there)."""
    x = torch.zeros_like(rhs)
    r = rhs
    p = apply_minv(r)
    rz = torch.sum(r * p)
    check_every = 1 if rhs.device.type == "cpu" else 10
    for i in range(iters):
        go = keep_going(r)
        if i % check_every == 0 and not bool(go):
            break
        Ap = matvec(p)
        alpha = rz / safe_pAp(torch.sum(p * Ap))
        x_n = x + alpha * p
        r_n = r - alpha * Ap
        z = apply_minv(r_n)
        rz_n = torch.sum(r_n * z)
        p_n = z + (rz_n / _floor_abs(rz)) * p
        x, r, p, rz = (torch.where(go, a, b) for a, b in ((x_n, x), (r_n, r), (p_n, p),
                                                           (rz_n, rz)))
    return x
