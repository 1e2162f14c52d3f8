"""Distributed full-map bundle adjustment: keyframe-block sharded maps.

Port of `orbslam_mapsave_tpu/parallel/dist_gba.py`. The keyframe
trajectory is split into one block per rank and the map points into as
many point blocks. One mesh axis, two co-sharded families of the dual
edge layout of `optim/global_ba.build_tables`:

- camera-major (K, N) lanes: every camera-side sum (Hcc, gc, W z) is local
  to the rank that owns the keyframe block;
- point-major (P, O) lanes: every point-side sum (Hpp, gp, W^T x) is local
  to the rank that owns the point block;
- the poses are replicated. Per PCG matvec the ranks exchange one tiled
  all-gather of z = Hpp^-1 W^T x (P, 3) and one of the (K, 6) product;
  the reduced camera system is never built.

The PCG is the JAX version's own: implicit Schur products, preconditioned
by the inverse of the Schur diagonal Hcc_d - sum W Hpp^-1 W^T over each
keyframe's lanes (not `global_ba._solve_pcg_dual`'s damped-Hcc blocks),
stopping at |r| <= cg_tol * |rhs|. Its `lax.while_loop` is `lm.pcg`'s fixed
trip count with frozen iterates; the host's stop test there reads the
residual of the all-gathered (replicated) vectors, so every rank leaves
the loop at the same iteration. The LM accept test compares the psum of
the ranks' costs, the same value on every rank.

Each rank holds the whole map (the live system runs replicated on every
rank): `distributed_full_ba` builds the tables from it on every rank and
keeps this rank's blocks (`shard_tables`). `shard_map_state` gives the
map's own keyframe- and point-major arrays the same placement.
"""

from __future__ import annotations

import torch

from ..geometry import projection, se3
from ..optim import global_ba as gba
from ..optim import lm
from ..slammap import mapstate as ms
from .mesh import Mesh, check_replicated, local_rows


def shard_map_state(state: ms.MapState, mesh: Mesh) -> ms.MapState:
    """Keyframe-block + landmark-block placement of the SoA map on this
    rank's device: an array whose leading axis is K or P keeps this rank's
    block of rows (covis (K,K) shards its rows), every other field (the
    counts) is replicated. The capacities must divide by the mesh size."""
    K, P = state.kf_capacity, state.pt_capacity

    def place(x):
        if isinstance(x, torch.Tensor) and x.dim() >= 1 and x.shape[0] in (K, P):
            return local_rows(x, mesh).to(mesh.device)
        return x.to(mesh.device) if isinstance(x, torch.Tensor) else x

    return ms.MapState(*(place(x) for x in state))


_SHARDED = ("po_cam", "po_uv", "po_ur", "po_is2", "po_valid",
            "cm_pt", "cm_uv", "cm_ur", "cm_is2", "cm_valid", "pt_valid")


def shard_tables(tb: gba.FullBATables, mesh: Mesh) -> gba.FullBATables:
    """This rank's part of the dual-layout tables on its device: the po_*,
    cm_* and pt_valid blocks, the camera masks whole."""
    return gba.FullBATables(**{
        f: (local_rows(x, mesh) if f in _SHARDED else x).to(mesh.device)
        for f, x in tb._asdict().items()})


def make_distributed_gba(cam: projection.Camera, mesh: Mesh, n_iters: int = 10,
                         robust: bool = False, cg_iters: int = 100, cg_tol: float = 1e-3):
    """run(tables, kf_pose, pt_pos) -> (kf_pose, pt_pos, cost) over tables
    placed by `shard_tables`: kf_pose (K,4,4) whole, pt_pos this rank's
    point block; it returns the poses replicated and orthonormalized, this
    rank's points and the whole map's cost (JAX `make_distributed_gba`)."""

    def run(tb: gba.FullBATables, poses: torch.Tensor, pts_l: torch.Tensor):
        Kl = tb.cm_pt.shape[0]
        k0 = mesh.axis_index() * Kl  # global slot of local keyframe row 0
        cam_free_l = tb.cam_free[k0:k0 + Kl]
        pt_ix = torch.clamp(tb.cm_pt, min=0).long()
        eye6 = torch.eye(6, dtype=pts_l.dtype, device=pts_l.device)

        def accept_cost(poses, pts_l):
            return mesh.psum(gba._accept_cost(cam, poses, pts_l, tb, robust))

        def solve_pcg(poses, pts_l, lam):
            pts_full = mesh.all_gather(pts_l)
            # point-major lanes of the local point block
            _, _, _, W_po, Hpp_inv, gp, pt_has = gba._point_blocks(cam, poses, pts_l, tb,
                                                                   robust, lam)
            cam_ix = torch.clamp(tb.po_cam, min=0).long()
            # camera-major lanes of the local keyframe block
            r_cm, Jc_cm, Jp_cm, chi2_cm, okz_cm, st_cm = gba._edge_terms(
                cam, poses[k0:k0 + Kl, None], pts_full[pt_ix], tb.cm_uv, tb.cm_ur, tb.cm_is2)
            free_row = cam_free_l[:, None] & tb.cm_valid
            Jc_cm = torch.where(free_row[..., None, None], Jc_cm, torch.zeros_like(Jc_cm))
            w_cm = gba._weights(chi2_cm, okz_cm, tb.cm_valid, tb.cm_is2, st_cm, robust)
            wJc = Jc_cm * w_cm[..., None, None]
            Hcc = torch.sum(wJc[..., :, :, None] * Jc_cm[..., :, None, :], dim=(1, 2))
            gc = -torch.sum(wJc * r_cm[..., None], dim=(1, 2))
            W_cm = torch.sum(wJc[..., :, :, None] * Jp_cm[..., :, None, :], dim=-3)
            Hcc_d = gba._damped_cams(Hcc, lam, cam_free_l)  # (Kl,6,6)
            # the Hpp^-1 rows the keyframe block reads live on every rank
            Hinv_cm = mesh.all_gather(Hpp_inv)[pt_ix]  # (Kl,N,3,3)

            def cam_side(z_l):  # sum over a keyframe's lanes of W z: (Pl,3) -> (Kl,6)
                z_lane = mesh.all_gather(z_l)[pt_ix]
                return torch.sum(W_cm * z_lane[..., None, :], dim=(1, 3))

            def matvec(x):  # (K,6) replicated -> (K,6) replicated
                a_l = torch.sum(Hcc_d * x[k0:k0 + Kl, None, :], dim=-1)
                t = torch.sum(W_po * x[cam_ix][..., :, None], dim=(1, 2))  # (Pl,3)
                z_l = torch.sum(Hpp_inv * t[:, None, :], dim=-1)
                return mesh.all_gather(a_l - cam_side(z_l))

            gp_z = torch.sum(Hpp_inv * gp[:, None, :], dim=-1)
            rhs_l = gc - cam_side(gp_z)
            rhs = mesh.all_gather(torch.where(cam_free_l[:, None], rhs_l,
                                              torch.zeros_like(rhs_l)))

            WHW = torch.einsum("knab,knbc,kndc->knad", W_cm, Hinv_cm, W_cm)
            S_diag = torch.where(cam_free_l[:, None, None], Hcc_d - torch.sum(WHW, dim=1),
                                 eye6)
            Minv_l = gba._inv_blocks(S_diag)

            def apply_minv(r):
                return mesh.all_gather(torch.sum(Minv_l * r[k0:k0 + Kl, None, :], dim=-1))

            tol = cg_tol * torch.clamp(torch.sqrt(torch.sum(rhs * rhs)), min=1e-20)
            dx_cam = lm.pcg(matvec, apply_minv, rhs, cg_iters,
                            lambda r: torch.sqrt(torch.sum(r * r)) > tol)
            dx_cam = torch.where(torch.isfinite(dx_cam) & tb.cam_free[:, None], dx_cam,
                                 torch.zeros_like(dx_cam))
            return dx_cam, gba._backsub_points(tb, W_po, Hpp_inv, gp, pt_has, dx_cam)

        free = tb.cam_free[:, None]
        cur = accept_cost(poses, pts_l)
        lam = torch.tensor(1e-4, dtype=pts_l.dtype, device=pts_l.device)
        for _ in range(n_iters):
            dxc, dxp = solve_pcg(poses, pts_l, lam)
            new_poses = se3.se3_exp(torch.where(free, dxc, torch.zeros_like(dxc))) @ poses
            new_pts = pts_l + dxp
            new = accept_cost(new_poses, new_pts)
            accept = new < cur
            poses = torch.where(accept, new_poses, poses)
            pts_l = torch.where(accept, new_pts, pts_l)
            cur = torch.where(accept, new, cur)
            lam = torch.clamp(torch.where(accept, lam * 0.5, lam * 5.0), 1e-9, 1e8)
        return se3.orthonormalize(poses), pts_l, cur

    return run


def distributed_full_ba(cam: projection.Camera, state: ms.MapState, inv_level_sigma2,
                        mesh: Mesh, n_iters: int = 10, robust: bool = False,
                        cg_iters: int = 100):
    """The whole map's GBA over the mesh: the dual-layout tables built from
    `state` (whole, on every rank), this rank's blocks kept, the
    distributed LM run. Returns (kf_pose (K,4,4), pt_pos (P,3), cost), all
    whole on every rank: the JAX version leaves the points sharded, here
    they are gathered so that each rank can apply the whole map. Raises
    ValueError on every rank when the ranks' maps differ."""
    kf_sum = torch.sum(torch.where(state.kf_valid[:, None, None], state.kf_pose.double(), 0.0))
    pt_sum = torch.sum(torch.where(state.pt_valid[:, None], state.pt_pos.double(), 0.0))
    check_replicated(mesh, "the map (n_kf, n_pt, sums of the live poses and points)",
                     state.n_kf, state.n_pt, kf_sum, pt_sum)
    isig = torch.as_tensor(inv_level_sigma2, dtype=torch.float32, device=state.device)
    tb = shard_tables(gba.build_tables(state, isig), mesh)
    run = make_distributed_gba(cam, mesh, n_iters=n_iters, robust=robust, cg_iters=cg_iters)
    poses, pts_l, cost = run(tb, state.kf_pose.to(mesh.device),
                             local_rows(state.pt_pos, mesh).to(mesh.device))
    return poses, mesh.all_gather(pts_l), cost
