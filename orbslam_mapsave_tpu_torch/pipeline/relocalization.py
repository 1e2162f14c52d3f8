"""Relocalization: candidate retrieval + batched EPnP RANSAC + pose LM.

Port of `orbslam_mapsave_tpu/pipeline/relocalization.py`,
`Tracking::Relocalization` parity (`src/Tracking.cc:1601-1775`):
candidates from `KeyFrameDatabase::DetectRelocalizationCandidates`
(vocab/database.py, sparse store) or, without a vocabulary or a store, the
5 newest valid keyframes; per candidate descriptor matching (>= 15,
`:1636`), EPnP RANSAC with minInliers 10 / 300 hypotheses / chi2 5.991 x
sigma2 (`:1653`, ops/epnp.py), `PoseOptimization`, the widening re-search
ladder (`:1709-1752`) and the 50-inlier acceptance (`:1754`).

All candidates run batched over a leading candidate axis: one matching
pass, one RANSAC pass over every candidate's hypotheses, and each pose-LM
step (the first and the two ladder steps) is ONE call of
`pose_opt.pose_optimization_batched` with B = the number of candidates,
which on the card is one launch of the pose-LM kernel. The JAX version
pads the candidate axis to 5 with copies of the first candidate and runs
the ladder unconditionally, selecting per candidate; here B is the number
of candidates, and a step that no candidate can still pass is skipped on
the host (a read of one small tensor): no candidate with >= 15 matches
ends the attempt after matching, none that RANSAC accepted ends it after
RANSAC, and a ladder step runs only if an accepted candidate needs it.
The accepted result is the one the full batch would give.

RANSAC draws its hypotheses from a `torch.Generator` per candidate, seeded
from the frame id and the candidate's keyframe slot (the JAX PRNG stream
cannot be reproduced); `batch` takes them as an argument instead, so the
tests hand both sides JAX's draws. In a process group of n > 1 ranks whose
size divides the store's rows, the candidates come from the sharded query
of `parallel/dist_reloc` (the JAX version's multi-device branch), with its
own gates: no covisibility-group accumulation, a per-shard top-k.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..geometry import projection
from ..ops import epnp, hamming, matching
from ..optim import pose_opt
from ..parallel import dist_reloc
from ..parallel import mesh as pmesh
from ..slammap import mapstate as ms
from ..utils import metrics
from ..vocab import database, vocabulary

N_HYP = 300  # RANSAC hypotheses per candidate (`Tracking.cc:1653`)
MIN_MATCHES = 15  # `Tracking.cc:1636`
ACCEPT_INLIERS = 50  # `Tracking.cc:1754`

_I32 = torch.int32


def _c0(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(x, min=0).long()


class RelocBatch(NamedTuple):
    """Per candidate (C,) of one attempt. `n_opt` is 0 for a candidate that
    failed the match or RANSAC gate; the pose and matches of such a
    candidate are not defined."""

    n_matches: torch.Tensor  # (C,) i32 descriptor matches
    ransac_inliers: torch.Tensor  # (C,) i32
    n_opt_first: torch.Tensor  # (C,) i32 inliers after the first pose LM
    take1: torch.Tensor  # (C,) bool the wide re-search replaced the result
    take2: torch.Tensor  # (C,) bool the narrow re-search replaced it
    pose: torch.Tensor  # (C,4,4) f32 Tcw
    matched: torch.Tensor  # (C,N) i32 point slot per frame feature or -1
    n_opt: torch.Tensor  # (C,) i32 final inliers
    lm_steps: int  # batched pose-LM calls made (0-3)


class Relocalizer:
    def __init__(self, cam: projection.Camera, inv_level_sigma2,
                 voc: vocabulary.Vocabulary | None = None, bow_store_ref=None,
                 max_candidates: int = 5):
        self.cam = cam
        self.inv_level_sigma2 = np.asarray(inv_level_sigma2, np.float32)
        self.level_sigma2 = (1.0 / self.inv_level_sigma2).astype(np.float32)
        # pyramid geometry recovered from the sigma table, as the JAX
        # version does: sigma2(level) = scale_factor^(2*level)
        self.scale_factors = np.sqrt(self.level_sigma2).astype(np.float32)
        self.n_levels = int(self.level_sigma2.shape[0])
        self.scale_factor = (float(self.scale_factors[1]) / max(float(self.scale_factors[0]),
                                                                1e-9)
                             if self.n_levels > 1 else 1.5)
        self.bounds = projection.compute_image_bounds(cam)
        self.voc = voc
        self.transform = vocabulary.make_transform_packed(voc) if voc else None
        self.bow_store_ref = bow_store_ref  # callable -> SparseBowStore or None
        self.max_candidates = max_candidates
        self._tables: dict = {}
        self._dist = None  # (mesh, sharded query) of the current world size

    def _t(self, dev):
        """(level_sigma2, inv_level_sigma2, scale_factors, bounds) on dev."""
        if dev not in self._tables:
            self._tables[dev] = tuple(torch.from_numpy(a).to(dev) for a in (
                self.level_sigma2, self.inv_level_sigma2, self.scale_factors, self.bounds))
        return self._tables[dev]

    def candidates(self, state: ms.MapState, frame) -> list[int]:
        """Keyframe slots to try, best first: BoW retrieval sorted by score
        (at most max_candidates) when a vocabulary and a store exist, else
        the newest valid keyframes (`relocalization.py:168-209`). Across
        ranks the retrieval is the sharded query (`relocalization.py:178-196`)."""
        store = self.bow_store_ref() if self.bow_store_ref else None
        if self.voc is not None and store is not None:
            out = self.transform(frame.desc, frame.valid)
            q_word, q_weight = vocabulary.sparse_bow(out["word"], out["weight"],
                                                     store.word.shape[1])
            n = pmesh.world_size()
            if n > 1 and store.word.shape[0] % n == 0:
                return self._sharded_candidates(store, state, q_word, q_weight, n)
            keep, scores = database.detect_relocalization_candidates_sparse(
                store, state, q_word, q_weight)
            cands = np.nonzero(keep.cpu().numpy())[0]
            order = np.argsort(-scores.cpu().numpy()[cands])
            return [int(c) for c in cands[order][: self.max_candidates]]
        valid = np.nonzero(state.kf_valid.cpu().numpy())[0]
        return [int(k) for k in valid[-self.max_candidates:][::-1]]

    def _sharded_candidates(self, store, state, q_word, q_weight, n: int) -> list[int]:
        """The sharded query's slots >= 0, by score, at most max_candidates;
        the query is built once per world size. Every rank shards its own
        store, so the ranks' stores and queries are checked equal first."""
        if self._dist is None or self._dist[0].size != n:
            mesh = pmesh.make_mesh(device=store.word.device)
            self._dist = (mesh, dist_reloc.make_distributed_query(mesh,
                                                                  top_k=self.max_candidates))
        mesh, query = self._dist
        pmesh.check_replicated(mesh, "the BoW store, the live keyframes and the query",
                               torch.sum(store.word.double()), torch.sum(store.weight.double()),
                               torch.sum(state.kf_valid), torch.sum(q_word.double()),
                               torch.sum(q_weight.double()))
        slots, scores = query(dist_reloc.shard_store(store, mesh), state.kf_valid,
                              q_word, q_weight)
        slots, s = slots.cpu().numpy(), scores.cpu().numpy()
        keep = slots >= 0
        order = np.argsort(-s[keep])
        return [int(c) for c in slots[keep][order][: self.max_candidates]]

    def draw_hypotheses(self, frame_id: int, cands: list[int],
                        valid: torch.Tensor) -> torch.Tensor:
        """(C, N_HYP, 4) RANSAC row indices: per candidate a generator
        seeded from the frame id and its keyframe slot draws 4 distinct
        valid rows per hypothesis (`epnp.draw_hypotheses`)."""
        out = []
        for c, v in zip(cands, valid):
            gen = torch.Generator(device=v.device)
            gen.manual_seed(frame_id * 131 + c)
            out.append(epnp.draw_hypotheses(v, N_HYP, gen))
        return torch.stack(out)

    def _opt_pose(self, state, frame, pose0, matched):
        """Batched `PoseOptimization` over each candidate's matches
        (`Tracking.cc:1680`); outliers leave the match set."""
        _, inv_ls2, _, _ = self._t(state.device)
        C = matched.shape[0]
        obs = pose_opt.PoseObs(
            pt_w=state.pt_pos[_c0(matched)],
            uv=frame.kp_xy.expand(C, -1, -1), ur=frame.kp_ur.expand(C, -1),
            inv_sigma2=inv_ls2[_c0(frame.kp_octave)].expand(C, -1),
            valid=matched >= 0)
        pose, inlier, n = pose_opt.pose_optimization_batched(self.cam, pose0, obs)
        return pose, torch.where(inlier, matched, torch.full_like(matched, -1)), n

    def _re_search(self, state, frame, cand, pose, matched, th: float, dist_th: int):
        """Projection re-search over each candidate keyframe's points not
        already in its match set (the `sFound` exclusion,
        `Tracking.cc:1717-1721`), no ratio test, ORB distance <= dist_th.

        The JAX version builds the "already matched" mask with one
        `.at[].set` in which unmatched rows write False to slot 0 and XLA
        applies duplicate writes in row order (`relocalization.py:100-102`):
        slot 0 holds the value of the LAST row that targets it. Reproduced
        here (as `tracking.track_local_map` does)."""
        _, _, sf, bounds = self._t(state.device)
        C, N = matched.shape
        P = state.pt_capacity
        kf_pts = state.kf_kp_point[cand]
        safe = _c0(kf_pts)
        ok = state.kf_kp_valid[cand] & (kf_pts >= 0) & state.pt_valid[safe]
        has = matched >= 0
        already = torch.zeros((C, P + 1), dtype=torch.bool, device=state.device)
        already.scatter_(1, torch.where(has, matched, P).long(), True)
        already = already[:, :P]
        to0 = matched <= 0
        last0 = (N - 1) - torch.argmax(torch.flip(to0, [1]).to(torch.int8), dim=1)
        slot0 = torch.gather(has, 1, last0[:, None])[:, 0]
        already[:, 0] = torch.where(to0.any(1), slot0, already[:, 0])
        ok = ok & ~torch.gather(already, 1, safe)
        new_m, _, _ = matching.search_by_projection_points(
            self.cam, pose, frame.kp_xy, frame.kp_octave, frame.desc_bits, frame.valid,
            has, state.pt_pos[safe], state.pt_normal[safe], state.pt_min_dist[safe],
            state.pt_max_dist[safe], hamming.unpack_bits(state.pt_desc[safe]), ok,
            bounds, sf, th=th, n_levels=self.n_levels, scale_factor=self.scale_factor,
            dist_th=dist_th, use_ratio=False)
        return torch.where((new_m >= 0) & ~has, torch.gather(kf_pts, 1, _c0(new_m)), matched)

    def batch(self, state: ms.MapState, frame, cands: list[int], frame_id: int = 0,
              hyp_idx: torch.Tensor | None = None) -> RelocBatch:
        """One attempt over the candidate keyframes `cands`: matching,
        RANSAC, pose LM and the ladder (`relocalization.py:60-165`), each
        stage batched over the candidates. hyp_idx (C, N_HYP, 4) fixes the
        RANSAC hypotheses (tests); otherwise `draw_hypotheses` draws them."""
        dev = state.device
        ls2, _, _, _ = self._t(dev)
        cand = torch.as_tensor(cands, dtype=torch.long, device=dev)
        C, N = len(cands), frame.kp_xy.shape[0]
        kf_pts = state.kf_kp_point[cand]
        kf_ok = state.kf_kp_valid[cand] & (kf_pts >= 0) & state.pt_valid[_c0(kf_pts)]
        matches, n = matching.search_by_descriptor(
            frame.desc_bits, frame.valid, hamming.unpack_bits(state.kf_desc[cand]), kf_ok,
            frame.kp_angle, state.kf_kp_angle[cand], th=hamming.TH_LOW, nn_ratio=0.75)
        matched = torch.where(matches >= 0, torch.gather(kf_pts, 1, _c0(matches)),
                              torch.full_like(matches, -1))
        zeros = torch.zeros(C, dtype=_I32, device=dev)
        no = torch.zeros(C, dtype=torch.bool, device=dev)
        eye = torch.eye(4, dtype=torch.float32, device=dev).expand(C, 4, 4)
        if not bool((n >= MIN_MATCHES).any()):
            return RelocBatch(n, zeros, zeros, no, no, eye, matched, zeros, 0)

        valid = matched >= 0
        if hyp_idx is None:
            hyp_idx = self.draw_hypotheses(frame_id, cands, valid)
        sigma2 = ls2[torch.clamp(frame.kp_octave, 0, self.n_levels - 1).long()]
        c = self.cam
        pose, inl, n_ransac, ransac_ok = epnp.ransac_pnp(
            state.pt_pos[_c0(matched)], frame.kp_xy.expand(C, -1, -1),
            (5.991 * sigma2).expand(C, -1), valid, hyp_idx,
            fx=c.fx, fy=c.fy, cx=c.cx, cy=c.cy, min_inliers=10)
        ok_all = ransac_ok & (n >= MIN_MATCHES)
        if not bool(ok_all.any()):
            return RelocBatch(n, n_ransac, zeros, no, no, eye, matched, zeros, 0)
        matched = torch.where(inl, matched, torch.full_like(matched, -1))
        pose, matched, n_opt = self._opt_pose(state, frame, pose, matched)
        n_first, steps = n_opt, 1

        # the widening ladder (`Tracking.cc:1709-1752`): < 50 inliers ->
        # wide re-search (th 10, ORB distance 100) and re-optimize; then
        # 30..50 -> narrow re-search (th 3, distance 64) and re-optimize
        take1 = n_opt < ACCEPT_INLIERS
        if bool((ok_all & take1).any()):
            m1 = self._re_search(state, frame, cand, pose, matched, 10.0, 100)
            p3, m1b, n1 = self._opt_pose(state, frame, pose, m1)
            steps += 1
            pose = torch.where(take1[:, None, None], p3, pose)
            matched = torch.where(take1[:, None], m1b, matched)
            n_opt = torch.where(take1, n1, n_opt)
        else:
            take1 = no
        take2 = (n_opt > 30) & (n_opt < ACCEPT_INLIERS)
        if bool((ok_all & take2).any()):
            m2 = self._re_search(state, frame, cand, pose, matched, 3.0, 64)
            p4, m2b, n2 = self._opt_pose(state, frame, pose, m2)
            steps += 1
            pose = torch.where(take2[:, None, None], p4, pose)
            matched = torch.where(take2[:, None], m2b, matched)
            n_opt = torch.where(take2, n2, n_opt)
        else:
            take2 = no
        return RelocBatch(n, n_ransac, n_first, take1, take2, pose, matched,
                          torch.where(ok_all, n_opt, zeros), steps)

    @metrics.traced("reloc.relocalize")
    def relocalize(self, state: ms.MapState, frame, frame_id: int):
        """Returns (pose (4,4), matched_pt (N,) i32, n_inliers) of the best
        candidate with >= 50 inliers after the ladder, or None."""
        cands = self.candidates(state, frame)
        if not cands:
            return None
        r = self.batch(state, frame, cands, frame_id)
        n_opt = r.n_opt.cpu().numpy()
        best = int(np.argmax(n_opt))
        if n_opt[best] >= ACCEPT_INLIERS:
            return r.pose[best], r.matched[best], int(n_opt[best])
        return None
