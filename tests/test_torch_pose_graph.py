"""Parity: the port's dense Sim3 pose graph (the essential-graph solver)
against the JAX package on the drifted-ring problem of `test_pose_graph.py`
(made from a seed with numpy), with a fixed vertex, an invalid vertex, dead
edge lanes and a scaled vertex. Residuals, Jacobians and optimized Sim3
poses within 1e-4; corrected points within 1e-4. The port's early exit
(a first gradient non-finite on every free entry) against its own full
loop, bit for bit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from functools import lru_cache

from test_pose_graph import pose_err, ring_problem

from orbslam_mapsave_tpu.geometry import se3 as jse3
from orbslam_mapsave_tpu.optim import pose_graph as jpg
from orbslam_mapsave_tpu_torch.geometry import se3 as tse3
from orbslam_mapsave_tpu_torch.optim import pose_graph as tpg

torch.set_num_threads(2)
TOL = 1e-4


@lru_cache(maxsize=4)
def _problem(seed=42, K=48, pad=0):
    """The ring problem plus what an essential graph holds: vertex 3 scaled
    by 1.05 (a loop-corrected Sim3), vertex 20 invalid, uneven edge weights,
    and `pad` dead edge lanes (0, 0) with an identity measurement, as the
    loop closer's edge compaction leaves them."""
    jprob, S_true = ring_problem(np.random.default_rng(seed), K=K)
    p = {k: np.array(v) for k, v in jprob._asdict().items()}
    p["S_init"][3, :3, :3] *= 1.05
    p["valid"][20] = False
    E = p["edge_i"].shape[0]
    p["edge_i"] = np.concatenate([p["edge_i"], np.zeros(pad, np.int32)])
    p["edge_j"] = np.concatenate([p["edge_j"], np.zeros(pad, np.int32)])
    p["edge_meas"] = np.concatenate([p["edge_meas"], np.tile(np.eye(4, dtype=np.float32),
                                                             (pad, 1, 1))])
    p["edge_valid"] = np.arange(E + pad) < E
    p["edge_weight"] = (1.0 + 0.5 * (np.arange(E + pad) % 3)).astype(np.float32)
    return (jpg.PoseGraphProblem(**{k: jnp.asarray(v) for k, v in p.items()}),
            tpg.PoseGraphProblem(**{k: torch.from_numpy(v) for k, v in p.items()}), S_true)


def test_linearize():
    jprob, tprob, _ = _problem(pad=6)
    K = jprob.S_init.shape[0]
    oh_j = jpg._edge_onehots(jprob, K)
    oh_t = tpg._edge_onehots(tprob, K)
    for a, b in zip(oh_t, oh_j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    rj, Jij, Jjj = jax.jit(jpg._linearize)(jprob.S_init, jprob, *oh_j)
    rt, Jit, Jjt = tpg._linearize(tprob.S_init, tprob, *oh_t)
    for a, b in ((rt, rj), (Jit, Jij), (Jjt, Jjj)):
        assert a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=TOL)
    np.testing.assert_allclose(tpg._residuals_only(tprob.S_init, tprob, *oh_t).numpy(),
                               np.asarray(rj), atol=TOL)


@pytest.mark.parametrize("variant", ["ring", "essential"])
def test_optimize_pose_graph_dense(variant):
    """20 iterations, as the loop closer runs them. The first steps solve a
    system that float32 barely resolves (lambda 1e-6 against a weak scale
    direction): the two packages' steps differ there by up to 4e-4, and
    the converged poses agree within 1e-4."""
    if variant == "ring":
        jprob, S_true = ring_problem(np.random.default_rng(42))
        tprob = tpg.PoseGraphProblem(**{k: torch.from_numpy(np.array(v))
                                        for k, v in jprob._asdict().items()})
    else:
        jprob, tprob, S_true = _problem()
    Sj, cj = jax.jit(lambda p: jpg.optimize_pose_graph(p, n_iters=20))(jprob)
    St, ct = tpg.optimize_pose_graph(tprob, n_iters=20)
    np.testing.assert_allclose(St.numpy(), np.asarray(Sj), atol=TOL)
    np.testing.assert_allclose(float(ct), float(cj), rtol=0.05, atol=1e-9)
    np.testing.assert_array_equal(St[0].numpy(), np.asarray(jprob.S_init[0]))  # fixed
    if variant == "ring":  # the ring closes: the chain moves back to the truth
        assert pose_err(St.numpy(), S_true) < 0.01 * pose_err(np.asarray(jprob.S_init), S_true)


def test_dead_lane_stalls_both():
    """Kept for parity: a dead lane's identity edge on an identity vertex
    has a NaN forward-mode Jacobian (the sqrt in so3_log at theta = 0), the
    one-hot assembly spreads it over the whole system and every step is
    zeroed, so the JAX solver returns its input (orthonormalized). The port
    does the same."""
    jprob, tprob, _ = _problem(pad=6)
    Sj, _ = jax.jit(lambda p: jpg.optimize_pose_graph(p, n_iters=4))(jprob)
    St, _ = tpg.optimize_pose_graph(tprob, n_iters=4)
    np.testing.assert_allclose(St.numpy(), np.asarray(Sj), atol=TOL)
    np.testing.assert_allclose(St.numpy(), tprob.S_init.numpy(), atol=TOL)


def test_failed_factorization_gives_zero_step():
    """A non-finite measurement makes the system non-factorizable: the
    poses come back as they went in (orthonormalized), no exception."""
    _, tprob, _ = _problem()
    meas = tprob.edge_meas.clone()
    meas[4] = float("nan")
    St, _ = tpg.optimize_pose_graph(tprob._replace(edge_meas=meas), n_iters=2)
    np.testing.assert_allclose(St.numpy(), tprob.S_init.numpy(), atol=TOL)


def test_sim3_to_se3_and_correct_points():
    rng = np.random.default_rng(5)
    xi = np.concatenate([rng.normal(size=(30, 6)) * 0.3, rng.normal(size=(30, 1)) * 0.1],
                        -1).astype(np.float32)
    S = np.array(jse3.sim3_exp(jnp.asarray(xi)))
    S_old = np.array(jse3.sim3_exp(jnp.asarray(xi[::-1].copy())))
    pts = rng.normal(size=(30, 3)).astype(np.float32) * 3
    np.testing.assert_allclose(tpg.sim3_to_se3(torch.from_numpy(S)).numpy(),
                               np.asarray(jpg.sim3_to_se3(jnp.asarray(S))), atol=TOL)
    np.testing.assert_allclose(
        tpg.correct_points(*map(torch.from_numpy, (pts, S_old, S))).numpy(),
        np.asarray(jpg.correct_points(*map(jnp.asarray, (pts, S_old, S)))), atol=TOL)


@pytest.mark.parametrize("variant", ["ring", "essential", "dead_lanes"])
def test_cg_matches_jax(variant):
    """The CG route (solver="cg", the loop closer's past K = 384) against
    JAX's CG on the same problem, 20 iterations: Sim3 poses within 1e-4.
    On the ring it also lands where the dense route does. With dead lanes
    (the loop closer's edge buffer) the NaN forward-mode Jacobian of the
    identity edge makes the first CG residual norm NaN, the CG loop stops
    before its first step in both packages, and the solve returns its input
    (orthonormalized), as the dense route does; the port's early exit stops
    there after one linearization (test_early_exit_equals_full_loop)."""
    if variant == "ring":
        jprob, _ = ring_problem(np.random.default_rng(42))
        tprob = tpg.PoseGraphProblem(**{k: torch.from_numpy(np.array(v))
                                        for k, v in jprob._asdict().items()})
    else:
        jprob, tprob, _ = _problem(pad=6 if variant == "dead_lanes" else 0)
    Sj, cj = jax.jit(lambda p: jpg.optimize_pose_graph(p, n_iters=20, solver="cg",
                                                       cg_iters=150))(jprob)
    St, ct = tpg.optimize_pose_graph(tprob, n_iters=20, solver="cg", cg_iters=150)
    np.testing.assert_allclose(St.numpy(), np.asarray(Sj), atol=TOL)
    np.testing.assert_allclose(float(ct), float(cj), rtol=0.05, atol=1e-9)
    np.testing.assert_array_equal(St[0].numpy(), np.asarray(jprob.S_init[0]))
    if variant == "ring":
        Sd, _ = tpg.optimize_pose_graph(tprob, n_iters=20)
        np.testing.assert_allclose(St.numpy(), Sd.numpy(), atol=1e-3)
    if variant == "dead_lanes":
        np.testing.assert_allclose(St.numpy(), tprob.S_init.numpy(), atol=TOL)


def _nan_measurement():
    """test_failed_factorization_gives_zero_step's problem."""
    _, tprob, _ = _problem()
    meas = tprob.edge_meas.clone()
    meas[4] = float("nan")
    return tprob._replace(edge_meas=meas)


def _negative_weight():
    """A finite gradient whose system does not factorize at small lambda: one
    edge's information is negative, so the damped Hessian is indefinite
    until the rejected steps have raised lambda far enough."""
    _, tprob, _ = _problem()
    wt = tprob.edge_weight.clone()
    wt[5] = -50.0
    return tprob._replace(edge_weight=wt)


def _rotated_slot0():
    """Dead lanes (0, 0) whose measurement the loop closer's way, S_0
    se3_inv(S_0), on a rotated slot-0 pose: the dead lanes' residual need
    not be exactly the identity."""
    _, tprob, _ = _problem(pad=6)
    S = tprob.S_init.clone()
    S[0] = tse3.se3_exp(torch.tensor([0.3, -0.2, 0.1, 0.4, -0.7, 0.25])) @ S[0]
    meas = tprob.edge_meas.clone()
    dead = ~tprob.edge_valid
    meas[dead] = S[0] @ tse3.se3_inv(S[0])
    return tprob._replace(S_init=S, edge_meas=meas)


def _perturbed():
    """The essential graph's construction on its live edges (chip_smoke's
    `_essential_solve`): every measurement taken from the poses the graph
    starts at, each free vertex then moved by a small Sim3 drawn from a
    seed, so that the solve must carry the vertices back."""
    _, tprob, _ = _problem()
    S = tprob.S_init
    meas = S[tprob.edge_i.long()] @ tse3.se3_inv(S[tprob.edge_j.long()])
    rng = np.random.default_rng(5)
    xi = np.concatenate([rng.normal(scale=0.01, size=(S.shape[0], 6)),
                         rng.normal(scale=0.002, size=(S.shape[0], 1))], 1).astype(np.float32)
    xi[0] = 0.0  # the fixed vertex
    return tprob._replace(S_init=tse3.sim3_exp(torch.from_numpy(xi)) @ S, edge_meas=meas)


# case: (problem, solver, whether the exit fires; None: either way)
EXIT_CASES = {
    "dead_lanes_dense": (lambda: _problem(pad=6)[1], "dense", True),
    "dead_lanes_cg": (lambda: _problem(pad=6)[1], "cg", True),
    "nan_measurement": (_nan_measurement, "dense", True),
    "live_dense": (lambda: _problem()[1], "dense", False),
    "live_cg": (lambda: _problem()[1], "cg", False),
    "perturbed": (_perturbed, "dense", False),
    "finite_g_failed_factorization": (_negative_weight, "dense", False),
    "dead_lanes_rotated_slot0": (_rotated_slot0, "dense", None),
}


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bit for bit, NaN included (a NaN measurement's chi2 is NaN)."""
    return torch.equal(a.reshape(-1).view(torch.int32), b.reshape(-1).view(torch.int32))


@pytest.mark.parametrize("case", list(EXIT_CASES))
def test_early_exit_equals_full_loop(case):
    """`optimize_pose_graph` against `_optimize_pose_graph_full` (the same
    loop without the exit), 20 iterations: S and chi2 bit-equal (NaN
    included); the
    iteration counter reads 1 where the exit fires and 20 where it must
    not."""
    make, solver, fires = EXIT_CASES[case]
    prob = make()
    tpg.reset_iterations()
    S, chi2 = tpg.optimize_pose_graph(prob, n_iters=20, solver=solver)
    ran = tpg.iterations
    tpg.reset_iterations()
    S_full, chi2_full = tpg._optimize_pose_graph_full(prob, n_iters=20, solver=solver)
    assert tpg.iterations == 20
    assert _same_bits(S, S_full) and _same_bits(chi2, chi2_full)
    if fires is not None:
        assert ran == (1 if fires else 20)
    else:
        assert ran in (1, 20)
    if fires:  # the stall: the input, orthonormalized
        assert torch.equal(S, tse3.sim3_orthonormalize(prob.S_init))
    if case in ("perturbed", "finite_g_failed_factorization"):  # the solve moves
        assert (S - tse3.sim3_orthonormalize(prob.S_init)).abs().max() > TOL
