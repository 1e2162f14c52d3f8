"""Sim3 pose-graph (essential graph) optimization for loop correction.

Port of `orbslam_mapsave_tpu/optim/pose_graph.py`
(`Optimizer::OptimizeEssentialGraph`, `src/Optimizer.cc:781-1062`):
vertices are per-keyframe Sim3 world->camera transforms, edges carry a
measured relative Sim3, the residual sim3_log(S_meas (exp(xi_i) S_i
(exp(xi_j) S_j)^-1)^-1) is linearized by forward-mode differentiation at
xi = 0 for all edges at once; 20 damped Gauss-Newton iterations, left
after the first where its gradient is non-finite in every free entry
(`optimize_pose_graph`: every later one would repeat it, so the result
is the same bits). Two
solvers: `"dense"` assembles the (7K,7K) normal system by incidence
contractions and solves it by Cholesky; `"cg"` (the loop closer's past
K = 384) keeps per-edge 7x7 blocks and runs block-Jacobi preconditioned
CG with its matrix-vector products through the (E,K) incidence.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from ..geometry import se3
from . import lm as lm_mod


class PoseGraphProblem(NamedTuple):
    S_init: torch.Tensor  # (K,4,4) initial Sim3 (sR|t) world->camera
    fixed: torch.Tensor  # (K,) bool
    valid: torch.Tensor  # (K,) bool
    edge_i: torch.Tensor  # (E,) i32
    edge_j: torch.Tensor  # (E,) i32
    edge_meas: torch.Tensor  # (E,4,4) measured S_ij = S_i S_j^-1
    edge_valid: torch.Tensor  # (E,)
    edge_weight: torch.Tensor  # (E,) information scale (1.0 default)


def _edge_residual(S_i, S_j, S_meas, xi_i, xi_j):
    rel = (se3.sim3_exp(xi_i) @ S_i) @ se3.sim3_inv(se3.sim3_exp(xi_j) @ S_j)
    return se3.sim3_log(S_meas @ se3.sim3_inv(rel))


def _edge_onehots(prob: PoseGraphProblem, K: int):
    """(E,K) f32 incidence of each edge's endpoints: the Hessian and
    gradient are assembled as contractions against these (exact for 0/1
    operands, and order-free, unlike a float scatter-add)."""
    ids = torch.arange(K, dtype=torch.int32, device=prob.edge_i.device)
    return ((prob.edge_i[:, None] == ids).to(torch.float32),
            (prob.edge_j[:, None] == ids).to(torch.float32))


def _select_poses(S: torch.Tensor, oh: torch.Tensor) -> torch.Tensor:
    return (oh @ S.reshape(S.shape[0], 16)).reshape(-1, 4, 4)


def _linearize(S, prob: PoseGraphProblem, oh_i, oh_j):
    """Residuals (E,7) and Jacobians (E,7,7) x2 at xi=0 for all edges."""
    Si, Sj = _select_poses(S, oh_i), _select_poses(S, oh_j)
    z = torch.zeros(Si.shape[0], 7, dtype=S.dtype, device=S.device)
    r = _edge_residual(Si, Sj, prob.edge_meas, z, z)
    E = (Si.shape[0],)
    Ji = lm_mod.jacobian_at_zero(lambda x: _edge_residual(Si, Sj, prob.edge_meas, x, z),
                                 7, E, S)
    Jj = lm_mod.jacobian_at_zero(lambda x: _edge_residual(Si, Sj, prob.edge_meas, z, x),
                                 7, E, S)
    return r, Ji, Jj


def _residuals_only(S, prob: PoseGraphProblem, oh_i, oh_j):
    z7 = torch.zeros(7, dtype=S.dtype, device=S.device)
    return _edge_residual(_select_poses(S, oh_i), _select_poses(S, oh_j),
                          prob.edge_meas, z7, z7)


iterations = 0  # LM iterations run since the last reset (the early exit's evidence)


def reset_iterations() -> None:
    global iterations
    iterations = 0


def optimize_pose_graph(prob: PoseGraphProblem, n_iters: int = 20, solver: str = "dense",
                        cg_iters: int = 100, cg_tol: float = 1e-6):
    """Damped Gauss-Newton over the pose graph. Returns (S_opt (K,4,4),
    final chi2). A failed factorization gives a zero step, as the JAX
    version's NaN -> 0 rule does. `cg_iters` / `cg_tol` bound the inner
    solve of solver="cg".

    Leaves the loop after its first linearization when the first gradient
    g (the route's own, free rows only) is non-finite in every entry, and
    returns what all `n_iters` iterations return there. The loop closer's
    graphs do this: a dead lane (0, 0), or any edge whose residual is
    exactly the identity, has a NaN forward-mode `so3_log` Jacobian, and
    the incidence contractions spread it over every row of g. Then the
    step is zero for every lambda:
    - dense: each free entry of the right-hand side is NaN, so each free
      entry of the Cholesky solve is NaN, or the factorization fails; the
      NaN -> 0 rule zeroes the step either way;
    - CG: |g| is NaN, the first stop test `NaN > tol` is false, and the
      PCG returns its start, 0.
    `sim3_exp(0) @ S == S` bit for bit, so S, and with it the next
    linearization, never changes: every iteration repeats the first, and
    the result is `sim3_orthonormalize(S_init)` with its chi2 (lambda,
    the only state that changes, is not returned). A case outside this
    argument runs all `n_iters`: a finite g with a failed factorization
    (there lambda changes the step), or a g with some finite free entries
    (the dense route's NaN -> 0 rule keeps those). The test reads a value
    computed from the map, so every rank of a process group takes the
    same branch. `_optimize_pose_graph_full` is the loop without the exit."""
    return _optimize(prob, n_iters, solver, cg_iters, cg_tol, early_exit=True)


def _optimize_pose_graph_full(prob: PoseGraphProblem, n_iters: int = 20, solver: str = "dense",
                              cg_iters: int = 100, cg_tol: float = 1e-6):
    """`optimize_pose_graph` without its early exit: all `n_iters` run."""
    return _optimize(prob, n_iters, solver, cg_iters, cg_tol, early_exit=False)


def _optimize(prob: PoseGraphProblem, n_iters: int, solver: str, cg_iters: int, cg_tol: float,
              early_exit: bool):
    global iterations
    if solver not in ("dense", "cg"):
        raise ValueError(f"unknown pose-graph solver {solver!r}")
    K = prob.S_init.shape[0]
    free = prob.valid & ~prob.fixed
    oh_i, oh_j = _edge_onehots(prob, K)
    w = torch.where(prob.edge_valid, prob.edge_weight, torch.zeros_like(prob.edge_weight))

    def chi2_of(S):
        r = _residuals_only(S, prob, oh_i, oh_j)
        return torch.sum(w * torch.sum(r * r, -1))

    S = prob.S_init
    lam = torch.tensor(1e-6, dtype=S.dtype, device=S.device)
    for it in range(n_iters):
        iterations += 1
        r, Ji, Jj = _linearize(S, prob, oh_i, oh_j)
        if solver == "cg":  # fixed endpoints: zero Jacobians, identity rows
            free_f = free.to(S.dtype)
            Ji = Ji * (oh_i @ free_f)[:, None, None]
            Jj = Jj * (oh_j @ free_f)[:, None, None]
        cur = torch.sum(w * torch.sum(r * r, -1))
        blocks = (torch.einsum("eri,e,erj->eij", Ji, w, Ji),  # Hii
                  torch.einsum("eri,e,erj->eij", Jj, w, Jj),  # Hjj
                  torch.einsum("eri,e,erj->eij", Ji, w, Jj))  # Hij
        gi = -torch.einsum("eri,e,er->ei", Ji, w, r)
        gj = -torch.einsum("eri,e,er->ei", Jj, w, r)
        g = oh_i.T @ gi + oh_j.T @ gj
        if early_exit and it == 0 and bool(torch.all(~torch.isfinite(g) | ~free[:, None])):
            break  # every later iteration repeats this one (docstring)
        if solver == "cg":
            dx = _cg_step(free, oh_i, oh_j, blocks, g, lam, cg_iters, cg_tol)
        else:
            dx = _dense_step(free, oh_i, oh_j, blocks, g, lam)
        S_new = se3.sim3_exp(dx) @ S
        accept = chi2_of(S_new) < cur
        S = torch.where(accept, S_new, S)
        lam = torch.clamp(torch.where(accept, lam * 0.5, lam * 5.0), 1e-8, 1e8)
    # chained f32 sim3_exp products drift off scale x SO(3)
    S = se3.sim3_orthonormalize(S)
    return S, chi2_of(S)


def _dense_step(free, oh_i, oh_j, blocks, g, lam) -> torch.Tensor:
    """The step (K,7) from the (7K,7K) normal system assembled by incidence
    contractions and solved by Cholesky (g (K,7) the assembled gradient);
    fixed rows are the identity."""
    Hii, Hjj, Hij = blocks
    K = free.shape[0]
    mask = torch.repeat_interleave(free, 7)
    H = (torch.einsum("ea,eb,eij->abij", oh_i, oh_i, Hii)
         + torch.einsum("ea,eb,eij->abij", oh_j, oh_j, Hjj)
         + torch.einsum("ea,eb,eij->abij", oh_i, oh_j, Hij)
         + torch.einsum("ea,eb,eji->abij", oh_i, oh_j, Hij).transpose(0, 1))
    Hf = H.transpose(1, 2).reshape(K * 7, K * 7)
    Hf = torch.where(mask[:, None] & mask[None, :], Hf, torch.zeros_like(Hf))
    Hf = Hf + torch.diag(torch.where(mask, lam, torch.ones_like(lam)))
    gf = torch.where(mask, g.reshape(-1), torch.zeros_like(g.reshape(-1)))
    L, info = torch.linalg.cholesky_ex(Hf)
    dx = torch.cholesky_solve(gf[:, None], L)[:, 0].reshape(K, 7)
    return torch.where(torch.isfinite(dx) & (info == 0) & free[:, None], dx,
                       torch.zeros_like(dx))


def _cg_step(free, oh_i, oh_j, blocks, g, lam, cg_iters: int, cg_tol: float) -> torch.Tensor:
    """The step (K,7) by matrix-free PCG (JAX `_optimize_pose_graph_cg`):
    per-edge 7x7 blocks, endpoints selected and reduced through the (E,K)
    incidence, the damped block diagonal as block-Jacobi preconditioner,
    stopping at |r| / |g| <= cg_tol (g (K,7) the assembled gradient);
    fixed rows are the identity."""
    Hii, Hjj, Hij = blocks
    E, K = oh_i.shape
    eye7 = torch.eye(7, dtype=Hii.dtype, device=Hii.device)
    g = torch.where(free[:, None], g, torch.zeros_like(g))
    D = (oh_i.T @ Hii.reshape(E, 49) + oh_j.T @ Hjj.reshape(E, 49)).reshape(K, 7, 7)
    D = torch.where(free[:, None, None], D + eye7 * lam, eye7)
    Minv, info = torch.linalg.inv_ex(D)
    Minv = torch.where(torch.isfinite(Minv) & (info == 0)[:, None, None], Minv, eye7)
    HijT = Hij.transpose(1, 2)

    def matvec(x):  # (K,7); lam on free rows, the identity on fixed rows
        x = torch.where(free[:, None], x, torch.zeros_like(x))
        xi, xj = oh_i @ x, oh_j @ x
        yi = (Hii @ xi[..., None] + Hij @ xj[..., None])[..., 0]
        yj = (HijT @ xi[..., None] + Hjj @ xj[..., None])[..., 0]
        y = oh_i.T @ yi + oh_j.T @ yj + lam * x
        return torch.where(free[:, None], y, x)

    gn = torch.sqrt(torch.sum(g * g)) + 1e-30
    dx = lm_mod.pcg(matvec, lambda v: (Minv @ v[..., None])[..., 0], g, cg_iters,
                    lambda rr: torch.sqrt(torch.sum(rr * rr)) / gn > cg_tol,
                    safe_pAp=lambda d: torch.clamp(d, min=1e-30))
    return torch.where(torch.isfinite(dx) & free[:, None], dx, torch.zeros_like(dx))


def sim3_to_se3(S: torch.Tensor) -> torch.Tensor:
    """Recover SE3 poses: Tiw = [R | t/s] (`src/Optimizer.cc:1012-1027`)."""
    s, R, t = se3.sim3_split(S)
    return se3.rt_to_mat(R, t / s[..., None])


def correct_points(pt_pos: torch.Tensor, S_old_ref: torch.Tensor,
                   S_new_ref: torch.Tensor) -> torch.Tensor:
    """Move points with their reference KF's Sim3 correction
    (`src/Optimizer.cc:1031-1060`): X' = S_new^-1 (S_old X), one pose per
    point."""
    p_cam = torch.einsum("pij,pj->pi", S_old_ref[..., :3, :3], pt_pos) + S_old_ref[..., :3, 3]
    Sinv = se3.sim3_inv(S_new_ref)
    return torch.einsum("pij,pj->pi", Sinv[..., :3, :3], p_cam) + Sinv[..., :3, 3]
