"""Loop detection and correction.

Port of `orbslam_mapsave_tpu/pipeline/loop_closing.py` (the `LoopClosing`
thread, `src/LoopClosing.cc`) as host orchestration over torch ops:

- `DetectLoop` (`:104-230`): 10-keyframe refractory period, minScore over
  the query's covisibles, database candidates (vocab/database.py), the
  covisibility-consistency chain with threshold 3;
- `ComputeSim3` (`:232-401`): >= 20 descriptor matches, RANSAC Sim3
  (ops/sim3solver.py, 300 hypotheses, fixed scale for RGB-D), the guided
  `SearchBySim3` extension, `OptimizeSim3` >= 20 inliers, the Scw
  projection search over the loop neighbourhood accepting >= 40 matches;
- `CorrectLoop` (`:403-583`): Sim3 propagation to the covisible window,
  point correction, fusion of the matched features, `SearchAndFuse` over
  the window, the essential graph (optim/pose_graph.py), then a global-BA
  job (pipeline/gba.py) pumped 2 LM iterations per frame and applied with
  spanning-tree propagation.

The JAX version enqueues each stage as one device program and fetches its
result one keyframe later: detection is read at the next keyframe, the
Sim3 chain at the one after. Those lags decide which map state is
corrected, so the port keeps them although it could read at once. RANSAC
draws its hypotheses from a `torch.Generator` seeded with the keyframe
slot (the JAX PRNG stream cannot be reproduced). Duplicate-index writes are
order-free integer `scatter_reduce`s, so card runs repeat bit for bit.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..geometry import projection, se3
from ..ops import hamming, matching, sim3solver
from ..optim import pose_graph, sim3_opt
from ..slammap import mapstate as ms
from ..vocab import database, vocabulary
from . import gba as gba_mod
from . import local_mapping

CONSISTENCY_TH = 3  # LoopClosing.cc:43
REFRACTORY_KFS = 10  # LoopClosing.cc:115
LOOP_PT_CAP = 4096  # loop-neighbourhood point window for fusion
DETECT_TOP = 8  # candidates read per detection
SIM3_TRY = 3  # enough-consistent candidates verified per detection
FUSE_WINDOW = 24  # window KFs fused / reconnected at a loop event
EDGE_CAP_PER_KF = 16  # essential-graph edge capacity = 16 * K
ESSENTIAL_MIN_WEIGHT = 100  # Optimizer.cc:806
N_HYP = 300  # RANSAC hypotheses per Sim3 chain
N_GBA_ITERS = 10  # LM iterations of a loop's global-BA job

_I32 = torch.int32


_c0 = local_mapping._clip0
_top_k = database._top_k  # jax.lax.top_k: ties to the lower index


def _detect_device(store: database.SparseBowStore, state: ms.MapState,
                   q_word: torch.Tensor, q_weight: torch.Tensor, kf: int):
    """The device side of DetectLoop: minScore over the query's covisibles
    (`LoopClosing.cc:125-139`), gated candidates, the top DETECT_TOP by
    score and each one's covisibility-group row. Returns (top_ids, top_s,
    groups (DETECT_TOP,K) bool, has_covis)."""
    covis_r = ms.covisible_keyframes(state, kf, 30)
    sc = database.sparse_score_rows(store, _c0(covis_r), q_word, q_weight)
    has = covis_r >= 0
    min_score = torch.amin(torch.where(has, sc, torch.full_like(sc, torch.inf)))
    min_score = torch.where(torch.isfinite(min_score), min_score, torch.zeros_like(min_score))
    keep, scores = database.detect_loop_candidates_sparse(
        store, state, q_word, q_weight, kf, min_score)
    top_s, top_ids = _top_k(torch.where(keep, scores, torch.full_like(scores, -torch.inf)),
                            DETECT_TOP)
    return top_ids.to(_I32), top_s, state.covis[top_ids] > 0, has.any()


def _window_lanes(wmask: torch.Tensor, obs_kf: torch.Tensor) -> torch.Tensor:
    """(P,O) observation lanes whose keyframe is in the correction window,
    tested against the JAX version's bitmask. Kept for parity: the mask is
    a MAX scatter of 1 << (k & 31) into int32 words, so each 32-slot word
    keeps only its highest window keyframe (bit 31 is negative and never
    wins)."""
    K = wmask.shape[0]
    ids_k = torch.arange(K, dtype=_I32, device=wmask.device)
    bitval = torch.where(wmask, torch.bitwise_left_shift(torch.ones_like(ids_k), ids_k & 31),
                         torch.zeros_like(ids_k))
    words = torch.zeros((K + 31) // 32, dtype=_I32, device=wmask.device).scatter_reduce(
        0, (ids_k >> 5).long(), bitval, reduce="amax")
    po_safe = torch.clamp(obs_kf, min=0)
    bit = (words[(po_safe >> 5).long()] >> (po_safe & 31)) & 1
    return (obs_kf >= 0) & (bit > 0)


def essential_graph_problem(state: ms.MapState, kf: int,
                            match_kf: int) -> pose_graph.PoseGraphProblem:
    """The essential graph of a loop between kf and match_kf: spanning-tree
    + loop + covisibility >= 100 edges and the new loop pair, compacted into
    16*K edge lanes in row-major order (the lanes past the live edges are
    dead, (0, 0)); the matched KF fixed."""
    K = state.kf_capacity
    dev = state.device
    E_CAP = EDGE_CAP_PER_KF * K
    valid = state.kf_valid
    ids = torch.arange(K, dtype=_I32, device=dev)
    flag = (state.covis >= ESSENTIAL_MIN_WEIGHT).to(_I32).reshape(-1)
    par = state.kf_parent
    pe = (par >= 0) & valid & valid[_c0(par)]
    flag = flag.scatter_reduce(0, (ids * K + torch.clamp(par, min=0)).long(),
                               pe.to(_I32), reduce="amax")
    le = state.kf_loop_edges
    rows = ids[:, None].expand(le.shape)
    flag = flag.scatter_reduce(0, (rows * K + torch.clamp(le, min=0)).reshape(-1).long(),
                               (le >= 0).to(_I32).reshape(-1), reduce="amax")
    mask = flag.reshape(K, K) > 0
    mask[kf, match_kf] = True
    mask = mask | mask.T
    mask = mask & valid[:, None] & valid[None, :] & (ids[:, None] < ids[None, :])
    # compact the (K,K) mask into E_CAP edge lanes, row-major order
    f = mask.reshape(-1).to(_I32)
    pos = torch.cumsum(f, 0).to(_I32) - f
    okp = (f > 0) & (pos < E_CAP)
    lin = torch.arange(K * K, dtype=_I32, device=dev)
    buf = torch.full((E_CAP,), -1, dtype=_I32, device=dev).scatter_reduce(
        0, torch.where(okp, pos, E_CAP - 1).long(), torch.where(okp, lin, -1),
        reduce="amax")
    e_ok = buf >= 0
    ei = torch.where(e_ok, buf // K, 0)
    ej = torch.where(e_ok, buf % K, 0)
    poses = state.kf_pose
    fixed = torch.zeros(K, dtype=torch.bool, device=dev)
    fixed[match_kf] = True  # Optimizer.cc:820
    return pose_graph.PoseGraphProblem(
        S_init=poses, fixed=fixed, valid=valid, edge_i=ei, edge_j=ej,
        edge_meas=poses[ei.long()] @ se3.se3_inv(poses[ej.long()]), edge_valid=e_ok,
        edge_weight=torch.ones(E_CAP, dtype=torch.float32, device=dev))


@dataclasses.dataclass
class LoopEvent:
    query_kf: int
    match_kf: int
    n_inliers: int


class LoopCloser:
    """Host driver for loop closing; `process(state, kf)` is the Run-loop
    body (`src/LoopClosing.cc:58-89`). `fix_scale` (`mbFixScale`) holds
    the Sim3 scale at 1 for RGB-D and stereo; monocular leaves it free."""

    def __init__(self, cam: projection.Camera, inv_level_sigma2,
                 voc: vocabulary.Vocabulary, scale_factors, n_levels: int,
                 scale_factor: float, fix_scale: bool = True):
        self.cam = cam
        self.voc = voc
        self.fix_scale = fix_scale
        self.inv_level_sigma2 = np.asarray(inv_level_sigma2, np.float32)
        self.level_sigma2 = (1.0 / self.inv_level_sigma2).astype(np.float32)
        self.n_levels = n_levels
        self.scale_factor = scale_factor
        self.scale_factors = np.asarray(scale_factors, np.float32)
        self.bounds = projection.compute_image_bounds(cam)
        self.transform = vocabulary.make_transform_packed(voc)
        self.bow_store: database.SparseBowStore | None = None
        self.last_loop_kf = -REFRACTORY_KFS - 1
        self.consistent_groups: list[tuple[set, int]] = []
        self.events: list[LoopEvent] = []
        self.pending_gba: gba_mod.GBAJob | None = None
        self.gba_applied = 0
        self.gba_aborted = 0
        self._pending_detect = None  # (kf, device result) awaiting its read
        self._pending_sim3 = None  # (kf, candidates, device result)
        self._tables: dict = {}

    def _t(self, dev):
        """(level_sigma2, inv_level_sigma2, scale_factors, bounds) on dev."""
        if dev not in self._tables:
            self._tables[dev] = tuple(torch.from_numpy(a).to(dev) for a in (
                self.level_sigma2, self.inv_level_sigma2, self.scale_factors, self.bounds))
        return self._tables[dev]

    def reset(self):
        """Drop all loop-closing state (`System::Reset`); the event list and
        the applied / aborted job counts start again from zero."""
        if self.pending_gba is not None:
            self.pending_gba.abort()
            self.pending_gba = None
        self.gba_applied = self.gba_aborted = 0
        self.bow_store = None
        self.consistent_groups.clear()
        self.events.clear()
        self._pending_detect = None
        self._pending_sim3 = None
        self.last_loop_kf = -REFRACTORY_KFS - 1

    # -- BoW bookkeeping ---------------------------------------------------
    def _ensure_store(self, state: ms.MapState):
        if self.bow_store is None:
            m = min(state.n_features, max(self.voc.n_words, 1))
            self.bow_store = database.empty_sparse_store(state.kf_capacity, m, state.device)

    def compute_bow(self, state: ms.MapState, kf: int):
        """Sparse BoW row (words, weights) of one keyframe
        (`KeyFrame::ComputeBoW`, `src/KeyFrame.cc:781-789`)."""
        out = self.transform(state.kf_desc[kf], state.kf_kp_valid[kf])
        return vocabulary.sparse_bow(out["word"], out["weight"], self.bow_store.word.shape[1])

    def rebuild_store(self, state: ms.MapState) -> None:
        """Recompute the BoW row of every valid keyframe of a loaded map
        (`loop_closing.py:185-220`): the reference rebuilds its
        KeyFrameDatabase after `LoadMap` with `ComputeBoW` +
        `KeyFrameDatabase.add` per keyframe (`src/System.cc:155-171`);
        without it relocalization would only see keyframes added after the
        load. Invalid slots keep empty rows."""
        self.bow_store = None
        self._ensure_store(state)
        m = self.bow_store.word.shape[1]
        word, weight = self.bow_store.word.clone(), self.bow_store.weight.clone()
        for kf in torch.nonzero(state.kf_valid).flatten().tolist():
            out = self.transform(state.kf_desc[kf], state.kf_kp_valid[kf])
            word[kf], weight[kf] = vocabulary.sparse_bow(out["word"], out["weight"], m)
        self.bow_store = database.SparseBowStore(word=word, weight=weight)

    # -- main entry --------------------------------------------------------
    def process(self, state: ms.MapState, kf: int) -> ms.MapState:
        """The LoopClosing::Run body for one keyframe: its BoW row goes into
        the store, the previous detection is read, and this keyframe's
        detection is computed to be read at the next keyframe."""
        self._ensure_store(state)
        words, weights = self.compute_bow(state, kf)
        self.bow_store = database.add_keyframe_bow_sparse(self.bow_store, kf, words, weights)
        state = self.poll_detect(state)
        # slot allocation is monotone, so the slot bounds the keyframe count
        # (LoopClosing.cc:114-120 refractory gates)
        if kf - self.last_loop_kf < REFRACTORY_KFS or kf < 11:
            return state
        self._pending_detect = (kf, _detect_device(self.bow_store, state, words, weights, kf))
        return state

    def poll_detect(self, state: ms.MapState) -> ms.MapState:
        """Consume the pending stages: the Sim3 chain enqueued at the
        previous keyframe (correcting on acceptance), then the pending
        detection, whose candidates start a Sim3 chain read at the next
        keyframe."""
        state = self._poll_sim3(state)
        if self._pending_detect is None:
            return state
        kf, fut = self._pending_detect
        self._pending_detect = None
        if kf - self.last_loop_kf < REFRACTORY_KFS:
            return state  # a loop closed in the meantime
        cands = self._detect_host(kf, fut)[:SIM3_TRY]
        if not cands:
            return state
        gen = torch.Generator(device=state.device)
        gen.manual_seed(kf)
        outs = [self._sim3_chain(state, kf, c, generator=gen) for c in cands]
        self._pending_sim3 = (kf, cands, self._select_lane(outs))
        return state

    @staticmethod
    def _select_lane(outs: list[dict]) -> dict:
        """Best accepting lane by total matched features (first on ties)."""
        total = torch.stack([torch.sum((o["matched_pt"] >= 0).to(_I32)) for o in outs])
        acc = torch.stack([o["accept"] for o in outs])
        best = torch.argmax(torch.where(acc, total, torch.full_like(total, -1)))
        sel = {k: torch.stack([o[k] for o in outs])[best] for k in outs[0]}
        sel["which"] = best
        return sel

    def _poll_sim3(self, state: ms.MapState) -> ms.MapState:
        """Read an enqueued Sim3-chain result; on acceptance, correct the
        CURRENT map state (the reference's loop thread also corrects a map
        that tracking and mapping extended since detection)."""
        if self._pending_sim3 is None:
            return state
        kf, cands, fut = self._pending_sim3
        self._pending_sim3 = None
        if kf - self.last_loop_kf < REFRACTORY_KFS:
            return state
        if not bool(fut["accept"]):
            return state
        cand = int(cands[int(fut["which"])])
        # both endpoints must still be live (a keyframe culled during the
        # read lag; the reference's isBad() re-checks, LoopClosing.cc:245-251)
        if not (bool(state.kf_valid[kf]) and bool(state.kf_valid[cand])):
            return state
        self.events.append(LoopEvent(kf, cand, int(fut["n2"])))
        self.last_loop_kf = kf
        self.consistent_groups.clear()
        return self._correct_loop(state, kf, cand, fut["S12"], fut["matched_pt"],
                                  fut["loop_pts"])

    # -- DetectLoop --------------------------------------------------------
    def _detect_host(self, kf: int, fut) -> list[int]:
        """Consistency chaining (`LoopClosing.cc:153-226`); returns the
        enough-consistent candidates, strongest score first."""
        top_ids, top_s, groups, has_covis = (x.cpu().numpy() for x in fut)
        if not bool(has_covis):
            return []
        live = np.isfinite(top_s)
        cand_slots = top_ids[live]
        if len(cand_slots) == 0:
            self.consistent_groups.clear()
            return []
        new_groups: list[tuple[set, int]] = []
        enough: list[int] = []
        scores = {}
        for c, s, grow in zip(cand_slots, top_s[live], groups[live]):
            group = {int(c)} | {int(x) for x in np.nonzero(grow)[0]}
            scores[int(c)] = float(s)
            consistency = 0
            for prev_group, prev_count in self.consistent_groups:
                if group & prev_group:
                    consistency = max(consistency, prev_count + 1)
            new_groups.append((group, consistency))
            if consistency >= CONSISTENCY_TH:
                enough.append(int(c))
        self.consistent_groups = new_groups
        return sorted(enough, key=lambda c: -scores[c])

    # -- ComputeSim3 -------------------------------------------------------
    @staticmethod
    def _per_feature_points(state: ms.MapState, kf: int) -> dict:
        """Each feature's point data (world position, distance band,
        descriptor bits) aligned to the feature axis."""
        pts = state.kf_kp_point[kf]
        safe = _c0(pts)
        ok = state.kf_kp_valid[kf] & (pts >= 0) & state.pt_valid[safe]
        return dict(ids=pts, ok=ok, world=state.pt_pos[safe],
                    mind=0.8 * state.pt_min_dist[safe], maxd=1.2 * state.pt_max_dist[safe],
                    bits=hamming.unpack_bits(state.pt_desc[safe]))

    def _sim3_chain(self, state: ms.MapState, kf: int, cand: int,
                    hyp_idx: torch.Tensor | None = None,
                    generator: torch.Generator | None = None) -> dict:
        """The ComputeSim3 chain (`src/LoopClosing.cc:232-401`) over fixed
        feature-aligned lanes with validity masks; the acceptance gates
        (>= 20 matches, RANSAC ok, >= 20 Sim3 inliers, >= 40 total) come
        back as one flag. hyp_idx fixes the RANSAC hypotheses (tests);
        otherwise they are drawn from `generator`."""
        cam = self.cam
        level_sigma2, _, scale_t, bounds_t = self._t(state.device)
        P = state.pt_capacity
        nl = level_sigma2.shape[0]
        b1 = hamming.unpack_bits(state.kf_desc[kf])
        b2 = hamming.unpack_bits(state.kf_desc[cand])
        f1 = self._per_feature_points(state, kf)
        f2 = self._per_feature_points(state, cand)
        matches, n = matching.search_by_descriptor(
            b1, f1["ok"], b2, f2["ok"], state.kf_kp_angle[kf], state.kf_kp_angle[cand],
            th=hamming.TH_LOW, nn_ratio=0.75)
        ok_n = n >= 20  # LoopClosing.cc:268
        m_ok = matches >= 0
        m_safe = _c0(matches)
        T1, T2 = state.kf_pose[kf], state.kf_pose[cand]
        pc1 = se3.transform_points(T1, f1["world"])
        pc2 = se3.transform_points(T2, f2["world"][m_safe])
        uv1 = state.kf_kp_xy[kf]
        uv2 = state.kf_kp_xy[cand][m_safe]
        o1 = torch.clamp(state.kf_kp_octave[kf], 0, nl - 1).long()
        o2 = torch.clamp(state.kf_kp_octave[cand][m_safe], 0, nl - 1).long()
        S12, inl, _, ok_ransac = sim3solver.ransac_sim3(
            pc1, pc2, uv1, uv2, N_HYP, fix_scale=self.fix_scale,
            max_err1=sim3solver.CHI2_SIM3 * level_sigma2[o1],
            max_err2=sim3solver.CHI2_SIM3 * level_sigma2[o2], valid=m_ok,
            fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy, min_inliers=20,
            hyp_idx=hyp_idx, generator=generator)

        # guided extension (SearchBySim3, ORBmatcher.cc:1105-1329)
        match12 = torch.where(m_ok & inl, matches, -1)
        already1 = match12 >= 0
        already2 = local_mapping._scatter_max(
            state.n_features, _c0(match12), already1) > 0
        extra12, _ = matching.search_by_sim3(
            cam, T1, T2, S12,
            uv1, state.kf_kp_octave[kf], b1, state.kf_kp_valid[kf], f1["world"], f1["ok"],
            f1["mind"], f1["maxd"], f1["bits"],
            state.kf_kp_xy[cand], state.kf_kp_octave[cand], b2, state.kf_kp_valid[cand],
            f2["world"], f2["ok"], f2["mind"], f2["maxd"], f2["bits"],
            already1, already2, bounds_t, scale_t, th=7.5,
            n_levels=self.n_levels, scale_factor=self.scale_factor)
        match12 = torch.where(match12 >= 0, match12, torch.where(extra12 >= 0, extra12, -1))

        # Sim3 optimization over the extended set (OptimizeSim3)
        e_ok = match12 >= 0
        e_safe = _c0(match12)
        o2e = torch.clamp(state.kf_kp_octave[cand][e_safe], 0, nl - 1).long()
        obs = sim3_opt.Sim3Obs(
            pc1=pc1, pc2=se3.transform_points(T2, f2["world"][e_safe]), uv1=uv1,
            uv2=state.kf_kp_xy[cand][e_safe], inv_sigma2_1=1.0 / level_sigma2[o1],
            inv_sigma2_2=1.0 / level_sigma2[o2e], valid=e_ok)
        S12_opt, inl2, n2 = sim3_opt.optimize_sim3(cam, S12, obs,
                                                  fix_scale=self.fix_scale)
        ok_n2 = n2 >= 20  # LoopClosing.cc:327-331
        matched_pt = torch.where(e_ok & inl2, f2["ids"][e_safe], -1).to(_I32)
        Scw = S12_opt @ T2  # mScw = gScm * gSmw (:333-336)

        # loop-neighbourhood points (mvpLoopMapPoints, :353-374): points of
        # cand + its covisibles, compacted to LOOP_PT_CAP
        neigh = ms.covisible_keyframes(state, cand, ms.MAX_OBS)
        rows = torch.cat([torch.full((1,), cand, dtype=_I32, device=state.device),
                          torch.where(neigh >= 0, neigh, cand)])
        row_ok = torch.cat([torch.ones(1, dtype=torch.bool, device=state.device), neigh >= 0])
        flat = torch.where(row_ok[:, None], state.kf_kp_point[rows.long()], -1).reshape(-1)
        flag = local_mapping._scatter_max(P, _c0(flat), flat >= 0)
        flag = torch.where(state.pt_valid, flag, 0)
        loop_pts = ms.compact_indices(flag, min(LOOP_PT_CAP, P))
        has_loop_pts = torch.any(loop_pts >= 0)

        # Scw projection search over the loop points (:376-386)
        lp = _c0(loop_pts)
        matched_flag = local_mapping._scatter_max(P, _c0(matched_pt), matched_pt >= 0) > 0
        lp_ok = (loop_pts >= 0) & state.pt_valid[lp] & ~matched_flag[lp]
        proj, _ = matching.search_by_projection_scw(
            cam, Scw, state.pt_pos[lp], lp_ok, 0.8 * state.pt_min_dist[lp],
            1.2 * state.pt_max_dist[lp], state.pt_normal[lp],
            hamming.unpack_bits(state.pt_desc[lp]), uv1, state.kf_kp_octave[kf], b1,
            state.kf_kp_valid[kf], matched_pt >= 0, bounds_t, scale_t, th=10.0,
            n_levels=self.n_levels, scale_factor=self.scale_factor)
        matched_pt = torch.where((matched_pt < 0) & (proj >= 0), loop_pts[_c0(proj)],
                                 matched_pt)
        total = torch.sum((matched_pt >= 0).to(_I32))
        accept = ok_n & ok_ransac & ok_n2 & has_loop_pts & (total >= 40)
        return dict(accept=accept, S12=S12_opt, n2=n2, matched_pt=matched_pt,
                    loop_pts=loop_pts)

    # -- CorrectLoop -------------------------------------------------------
    def _correct(self, state: ms.MapState, kf: int, match_kf: int, S_cl: torch.Tensor,
                 matched_pt: torch.Tensor, loop_pts: torch.Tensor) -> ms.MapState:
        """The loop correction (`src/LoopClosing.cc:403-583` minus pose graph
        and GBA): Sim3 propagation to the covisible window, point
        correction, matched-feature fusion, SearchAndFuse + UpdateConnections
        over the window, the loop edge."""
        K = state.kf_capacity
        dev = state.device
        _, inv_ls2, scale_t, bounds_t = self._t(dev)
        # the Sim3 chain ran one keyframe earlier: re-validate its point
        # slots against the CURRENT state (soft-deleted since)
        matched_pt = torch.where((matched_pt >= 0) & state.pt_valid[_c0(matched_pt)],
                                 matched_pt, -1)
        loop_pts = torch.where((loop_pts >= 0) & state.pt_valid[_c0(loop_pts)], loop_pts, -1)
        poses = state.kf_pose
        # window = current KF + its covisibles (:432)
        wmask = (state.covis[kf] > 0) & state.kf_valid
        wmask[kf] = True
        # corrected Sim3 per window KF: S_ik @ (gScm @ Smw) (:436-467)
        corr = (poses @ se3.se3_inv(poses[kf])) @ (S_cl @ poses[match_kf])
        # point correction through the FIRST window observer (:469-499)
        obs_kf = state.pt_obs_kf
        in_win = _window_lanes(wmask, obs_kf)
        has = in_win.any(-1) & state.pt_valid
        first_lane = torch.argmax(in_win.to(torch.int8), -1)
        ref = _c0(torch.gather(obs_kf, 1, first_lane[:, None])[:, 0])
        S_old = poses[ref]
        S_new_inv = se3.sim3_inv(corr)[ref]
        p_cam = torch.einsum("pij,pj->pi", S_old[:, :3, :3], state.pt_pos) + S_old[:, :3, 3]
        p_new = torch.einsum("pij,pj->pi", S_new_inv[:, :3, :3], p_cam) + S_new_inv[:, :3, 3]
        pt_pos = torch.where(has[:, None], p_new, state.pt_pos)
        # corrected poses folded back to SE3 (:459-467)
        s_w, R_w, t_w = se3.sim3_split(corr)
        kf_pose = torch.where(wmask[:, None, None], se3.rt_to_mat(R_w, t_w / s_w[..., None]),
                              poses)
        state = state._replace(pt_pos=pt_pos, kf_pose=kf_pose)

        # matched-feature fusion on the current KF (:516-533). A point
        # matched by two features would be written twice: only its first
        # feature merges or adds (the JAX version declares the indices
        # unique without deduplicating)
        P = state.pt_capacity
        existing = state.kf_kp_point[kf]
        has_match = matched_pt >= 0
        feat = torch.arange(state.n_features, dtype=_I32, device=dev)
        merge = has_match & (existing >= 0) & (existing != matched_pt)
        merge = merge & (local_mapping._first_row(P, _c0(matched_pt), merge)[_c0(matched_pt)]
                         == feat)
        state = ms.merge_points(state, torch.where(merge, existing, -1),
                                torch.where(merge, matched_pt, -1), merge)
        add = has_match & (state.kf_kp_point[kf] < 0)
        add = add & (local_mapping._first_row(P, _c0(matched_pt), add)[_c0(matched_pt)] == feat)
        state = ms.add_observations(state, kf, matched_pt, feat, add)
        state = ms.compute_distinctive_descriptors_idx(state, torch.clamp(matched_pt, min=0),
                                                       add)

        # SearchAndFuse + UpdateConnections over the top-FUSE_WINDOW window
        # KFs (:585-611, :544-562), in order
        w = torch.where(wmask, state.covis[kf], -1)
        w[kf] = 1 << 30
        w_top, win_kfs = _top_k(w, min(FUSE_WINDOW, K))
        for k, ok in zip(win_kfs.tolist(), (w_top > 0).tolist()):
            if ok:
                state = local_mapping.fuse_into_keyframe(
                    state, k, loop_pts, self.cam, bounds_t, scale_t, inv_ls2,
                    self.n_levels, self.scale_factor, th=4.0, prefer_candidate=True)
                state = ms.update_connections(state, k)

        # loop edge (:567-570): first free lane on each side
        le = state.kf_loop_edges.clone()
        free1 = torch.argmax((le[kf] < 0).to(torch.int8))
        le[kf, free1] = match_kf
        free2 = torch.argmax((le[match_kf] < 0).to(torch.int8))
        le[match_kf, free2] = kf
        return state._replace(kf_loop_edges=le)

    def _essential(self, state: ms.MapState, kf: int, match_kf: int) -> ms.MapState:
        """Essential-graph pose relaxation (`Optimizer::OptimizeEssentialGraph`,
        `src/Optimizer.cc:781-1062`) over `essential_graph_problem`; points
        corrected through their reference KF."""
        K = state.kf_capacity
        valid = state.kf_valid
        poses = state.kf_pose
        prob = essential_graph_problem(state, kf, match_kf)
        S_opt, _ = pose_graph.optimize_pose_graph(prob, n_iters=20,
                                                  solver="dense" if K <= 384 else "cg")
        # correct points through their reference KFs (Optimizer.cc:1031-1060)
        refs = state.pt_ref_kf
        safe_ref = torch.clamp(refs, 0, K - 1).long()
        p_new = pose_graph.correct_points(state.pt_pos, poses[safe_ref], S_opt[safe_ref])
        upd = state.pt_valid & (refs >= 0)
        return state._replace(
            pt_pos=torch.where(upd[:, None], p_new, state.pt_pos),
            kf_pose=torch.where(valid[:, None, None], pose_graph.sim3_to_se3(S_opt),
                                state.kf_pose))

    def _correct_loop(self, state: ms.MapState, kf: int, match_kf: int,
                      S_cur_loop: torch.Tensor, matched_pt: torch.Tensor,
                      loop_pts: torch.Tensor) -> ms.MapState:
        """Sim3 propagation + loop fusion + essential graph + GBA job
        (`src/LoopClosing.cc:403-583`)."""
        state = self._correct(state, kf, match_kf, S_cur_loop, matched_pt, loop_pts)
        state = self._essential(state, kf, match_kf)
        # global BA as a job (the reference's GBA thread, :571-575); a job
        # still pending from a previous loop is aborted (:409-427)
        if self.pending_gba is not None:
            self.pending_gba.abort()
            self.gba_aborted += 1
        self.pending_gba = gba_mod.GBAJob(state, self.cam, self._t(state.device)[1],
                                          n_iters=N_GBA_ITERS)
        return state

    def remap_keyframes(self, new_of_old: np.ndarray) -> None:
        """Apply a keyframe-slot compaction (`mapstate.compact_keyframes`) to
        the BoW store and the detector's host bookkeeping; pending stages
        are dropped (one missed retrieval, like a queue reset)."""
        self._pending_detect = None
        self._pending_sim3 = None
        old_ids = np.nonzero(new_of_old >= 0)[0]
        new_ids = new_of_old[old_ids]
        if self.bow_store is not None:
            word, weight = self.bow_store
            nw = torch.full_like(word, vocabulary._PAD)
            nv = torch.zeros_like(weight)
            dst = torch.as_tensor(new_ids, dtype=torch.long, device=word.device)
            src = torch.as_tensor(old_ids, dtype=torch.long, device=word.device)
            nw[dst] = word[src]
            nv[dst] = weight[src]
            self.bow_store = database.SparseBowStore(word=nw, weight=nv)
        remap = {int(o): int(n) for o, n in zip(old_ids, new_ids)}
        self.consistent_groups = [
            (g, c) for g, c in (({remap[x] for x in grp if x in remap}, c)
                                for grp, c in self.consistent_groups) if g]
        if self.last_loop_kf >= 0:
            self.last_loop_kf = remap.get(self.last_loop_kf, -REFRACTORY_KFS - 1)

    def poll_gba(self, state: ms.MapState, force: bool = False) -> ms.MapState:
        """Pump the pending GBA job 2 LM iterations (all of them with force,
        the flush paths) and apply it once every iteration has run (the
        reference joins the GBA thread, `LoopClosing.cc:643-786`)."""
        job = self.pending_gba
        if job is None:
            return state
        for _ in range(job.iters_left if force else 2):
            if job.done:
                break
            job.pump(max_iters=1)
        if not job.done:
            return state
        self.pending_gba = None
        if job.aborted:
            return state
        state = job.apply(state)
        self.gba_applied += 1
        return state
