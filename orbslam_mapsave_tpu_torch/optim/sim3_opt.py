"""Relative Sim3 refinement between two loop keyframes.

Port of `orbslam_mapsave_tpu/optim/sim3_opt.py` (`Optimizer::OptimizeSim3`,
`src/Optimizer.cc:1064-1259`): one Sim3 variable S12 with bidirectional
reprojection edges e1 = obs1 - proj(S12 X2), e2 = obs2 - proj(S12^-1 X1)
at per-octave information, Huber delta sqrt(10); 5 robust LM iterations,
the chi2 > 10 outliers dropped, then 10 more. The Jacobians come from
forward-mode differentiation at xi = 0 (`lm.jacobian_at_zero`), as the
JAX version's `jax.jacfwd`; the fixed-length LM loops need no host reads.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry import projection, se3
from . import lm as lm_mod

CHI2_SIM3_EDGE = 10.0
HUBER2 = 10.0


class Sim3Obs(NamedTuple):
    pc1: torch.Tensor  # (M,3) matched points in camera-1 frame
    pc2: torch.Tensor  # (M,3) matched points in camera-2 frame
    uv1: torch.Tensor  # (M,2) observation in image 1
    uv2: torch.Tensor  # (M,2) observation in image 2
    inv_sigma2_1: torch.Tensor  # (M,)
    inv_sigma2_2: torch.Tensor  # (M,)
    valid: torch.Tensor  # (M,)


def _residuals(cam: projection.Camera, S12: torch.Tensor, obs: Sim3Obs):
    S21 = se3.sim3_inv(S12)
    uv1_hat, z1 = projection.project(cam, se3.sim3_transform_points(S12, obs.pc2))
    uv2_hat, z2 = projection.project(cam, se3.sim3_transform_points(S21, obs.pc1))
    e1 = obs.uv1 - uv1_hat
    e2 = obs.uv2 - uv2_hat
    chi1 = torch.sum(e1 * e1, -1) * obs.inv_sigma2_1
    chi2 = torch.sum(e2 * e2, -1) * obs.inv_sigma2_2
    return e1, e2, chi1, chi2, (z1 > 0) & (z2 > 0)


def _rho(x: torch.Tensor) -> torch.Tensor:
    d = HUBER2 ** 0.5
    return torch.where(x <= HUBER2, x, 2 * d * torch.sqrt(torch.clamp(x, min=0)) - HUBER2)


def _total_chi2(cam, S12, obs, active, robust: bool):
    _, _, c1, c2, ok = _residuals(cam, S12, obs)
    val = _rho(c1) + _rho(c2) if robust else c1 + c2
    return torch.sum(torch.where(active & ok, val, torch.zeros_like(val)))


def _lm_phase(cam, S12, obs: Sim3Obs, active, robust: bool, n_iters: int,
              fix_scale: bool):
    lam = torch.tensor(1e-5, dtype=S12.dtype, device=S12.device)
    for _ in range(n_iters):
        e1, e2, c1, c2, okz = _residuals(cam, S12, obs)
        w_rob1 = lm_mod.huber_weight(c1, torch.full_like(c1, HUBER2)) if robust else 1.0
        w_rob2 = lm_mod.huber_weight(c2, torch.full_like(c2, HUBER2)) if robust else 1.0
        act = (active & okz).to(S12.dtype)
        w1 = obs.inv_sigma2_1 * w_rob1 * act
        w2 = obs.inv_sigma2_2 * w_rob2 * act
        S = S12
        J1, J2 = lm_mod.jacobian_at_zero(
            lambda x: _residuals(cam, se3.sim3_exp(x) @ S, obs)[:2], 7, (), S)
        if fix_scale:
            J1 = torch.cat([J1[..., :6], torch.zeros_like(J1[..., 6:])], -1)
            J2 = torch.cat([J2[..., :6], torch.zeros_like(J2[..., 6:])], -1)
        H = (torch.einsum("mia,m,mib->ab", J1, w1, J1)
             + torch.einsum("mia,m,mib->ab", J2, w2, J2))
        g = -(torch.einsum("mia,m,mi->a", J1, w1, e1)
              + torch.einsum("mia,m,mi->a", J2, w2, e2))
        dx = lm_mod.solve_spd(H, g, lam)
        if fix_scale:
            dx = torch.cat([dx[:6], torch.zeros_like(dx[6:])])
        S_new = se3.sim3_exp(dx) @ S12
        accept = _total_chi2(cam, S_new, obs, active, robust) < \
            _total_chi2(cam, S12, obs, active, robust)
        S12 = torch.where(accept, S_new, S12)
        lam = torch.clamp(torch.where(accept, lam * 0.5, lam * 5.0), 1e-9, 1e8)
    return S12


def optimize_sim3(cam: projection.Camera, S12_init: torch.Tensor, obs: Sim3Obs,
                  fix_scale: bool = False, n_a: int = 5, n_b: int = 10):
    """Two-stage LM on the 7-dim (6 if fix_scale) tangent. Returns (S12,
    inlier_mask, n_inliers)."""
    S12 = _lm_phase(cam, S12_init, obs, obs.valid, True, n_a, fix_scale)
    # drop outliers chi2 > 10 either direction (Optimizer.cc:1194-1209)
    _, _, c1, c2, okz = _residuals(cam, S12, obs)
    active = obs.valid & okz & (c1 <= CHI2_SIM3_EDGE) & (c2 <= CHI2_SIM3_EDGE)
    S12 = _lm_phase(cam, S12, obs, active, False, n_b, fix_scale)
    # back onto scale x SO(3) (chained f32 sim3_exp products drift)
    S12 = se3.sim3_orthonormalize(S12)
    _, _, c1, c2, okz = _residuals(cam, S12, obs)
    inlier = obs.valid & okz & (c1 <= CHI2_SIM3_EDGE) & (c2 <= CHI2_SIM3_EDGE)
    return S12, inlier, torch.sum(inlier.to(torch.int32))
