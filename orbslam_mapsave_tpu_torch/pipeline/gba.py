"""Global-BA job: snapshot, optimize, propagate corrections forward.

Port of `orbslam_mapsave_tpu/pipeline/gba.py`
(`LoopClosing::RunGlobalBundleAdjustment`, `src/LoopClosing.cc:643-786`):
the job takes the map at a loop event, the host pumps its LM iterations a
few per frame while tracking and mapping extend the map, and `apply`
merges the result into the CURRENT map — keyframes and points allocated
after the snapshot (slots >= the snapshot counts; allocation is monotone)
move with their spanning-tree parent / reference keyframe.

In a process group of n > 1 ranks whose size divides both capacities (the
counterpart of the JAX version's `len(jax.devices()) > 1`), the job runs
the keyframe-block sharded solver `parallel/dist_gba.distributed_full_ba`
over the ranks at construction, as JAX does: every rank builds the job at
the same loop event, so all of them reach its collectives. That job is not
incremental (`pump` has nothing to run, `done` is true at once).
"""

from __future__ import annotations

import torch

from ..geometry import projection, se3
from ..optim import global_ba
from ..parallel import dist_gba
from ..parallel import mesh as pmesh
from ..slammap import mapstate as ms
from ..utils import metrics


class GBAJob:
    """One in-flight global bundle adjustment over a map snapshot: pumped
    LM iterations in one process, the distributed solve across ranks."""

    def __init__(self, state: ms.MapState, cam: projection.Camera, inv_level_sigma2,
                 n_iters: int = 10):
        self.snap_n_kf = int(state.n_kf)
        self.snap_n_pt = int(state.n_pt)
        self.aborted = False
        self.applied = False
        self._cam = cam
        isig = torch.as_tensor(inv_level_sigma2, dtype=torch.float32, device=state.device)
        n = pmesh.world_size()
        self._incremental = not (n > 1 and state.kf_capacity % n == 0
                                 and state.pt_capacity % n == 0)
        if not self._incremental:
            self._solver = "multi-rank"
            mesh = pmesh.make_mesh(device=state.device)
            self.kf_pose_gba, self.pt_pos_gba, self.cost = dist_gba.distributed_full_ba(
                cam, state, isig, mesh, n_iters=n_iters)
            metrics.count("gba.iters.multi-rank", n_iters)
            self.iters_left = 0
            return
        # the solver rule of the JAX version: memory is capacity-driven
        # (the (P,O,K) one-hot), quality picks among the affordable solvers
        oh_bytes = state.pt_capacity * global_ba.O_GBA * state.kf_capacity * 4
        if oh_bytes >= 2 * 1024**3:
            self._solver = "pcg_dual"
        elif self.snap_n_kf <= 384:
            self._solver = "dense"
        else:
            self._solver = "pcg"
        self._tb, self._carry = global_ba.gba_init(cam, state, isig, solver=self._solver)
        self.iters_left = n_iters

    def pump(self, max_iters: int = 1) -> bool:
        """Run up to max_iters LM iterations; True while work remains."""
        if self.aborted:
            return False
        while self.iters_left > 0 and max_iters > 0:
            metrics.count(f"gba.iters.{self._solver}")
            with metrics.span("gba.iterate"):
                self._carry = global_ba.gba_iterate(self._cam, self._tb, *self._carry,
                                                    solver=self._solver)
            self.iters_left -= 1
            max_iters -= 1
        return self.iters_left > 0

    @property
    def done(self) -> bool:
        return self.aborted or self.iters_left <= 0

    def finish(self):
        """Run all remaining iterations (the flush paths)."""
        if not self.aborted:
            self.pump(max_iters=self.iters_left)

    def abort(self):
        """`mbStopGBA`: stop iterating and drop the result."""
        self.aborted = True
        self.iters_left = 0

    def apply(self, state: ms.MapState) -> ms.MapState:
        """Merge the finished GBA into the current (possibly grown) map:
        snapshot keyframes and points take the optimized values; younger
        keyframes follow their parent through the spanning tree
        (`src/LoopClosing.cc:697-707`), younger points their reference
        keyframe's before/after poses (`:760-776`)."""
        if self.aborted:
            return state
        if self._incremental:
            self.finish()
            # f32 exp()@pose chains drift off SO(3)
            self.kf_pose_gba = se3.orthonormalize(self._carry[0])
            self.pt_pos_gba = self._carry[1]
        self.applied = True
        return _apply_device(state, self.kf_pose_gba, self.pt_pos_gba,
                             self.snap_n_kf, self.snap_n_pt)


def _apply_device(state: ms.MapState, gba_poses: torch.Tensor, gba_pts: torch.Tensor,
                  snap_n_kf: int, snap_n_pt: int) -> ms.MapState:
    """The JAX `_apply_device`. Its K-step propagation loop in slot order
    (a parent is always allocated before its child) runs here over the
    keyframes allocated after the snapshot only, decided on the host from
    one read of (kf_valid, kf_parent); every other slot of that loop leaves
    its pose as it is."""
    K = state.kf_capacity
    dev = state.device
    cur_poses = state.kf_pose
    slots = torch.arange(K, dtype=torch.int32, device=dev)
    in_snap = (slots < snap_n_kf) & state.kf_valid
    new_poses = torch.where(in_snap[:, None, None], gba_poses, cur_poses)
    valid = state.kf_valid.cpu().tolist()
    parent = state.kf_parent.cpu().tolist()
    covered = [(k < snap_n_kf) and valid[k] for k in range(K)]
    for k in range(snap_n_kf, K):
        p = max(parent[k], 0)
        if valid[k] and parent[k] >= 0 and covered[p]:
            # T_child_parent from the apply-time chain, re-anchored on the
            # corrected parent (LoopClosing.cc:697-707)
            T_cp = cur_poses[k] @ se3.se3_inv(cur_poses[p])
            new_poses[k] = T_cp @ new_poses[p]
        covered[k] = covered[k] or valid[k]
    P = state.pt_capacity
    pslots = torch.arange(P, dtype=torch.int32, device=dev)
    old = (pslots < snap_n_pt) & state.pt_valid
    young = (pslots >= snap_n_pt) & state.pt_valid & (state.pt_ref_kf >= 0)
    ref = torch.clamp(state.pt_ref_kf, 0, K - 1).long()
    T_ref_old, T_ref_new = cur_poses[ref], new_poses[ref]
    p_cam = torch.einsum("nij,nj->ni", T_ref_old[:, :3, :3], state.pt_pos) + T_ref_old[:, :3, 3]
    Twc = se3.se3_inv(T_ref_new)
    p_prop = torch.einsum("nij,nj->ni", Twc[:, :3, :3], p_cam) + Twc[:, :3, 3]
    pt_pos = torch.where(old[:, None], gba_pts,
                         torch.where(young[:, None], p_prop, state.pt_pos))
    return state._replace(kf_pose=new_poses, pt_pos=pt_pos)
