"""Local mapping: keyframe processing, point culling, local BA, KF culling.

Port of `orbslam_mapsave_tpu/pipeline/local_mapping.py` (`LocalMapping`,
`src/LocalMapping.cc`): one mapping pass per new keyframe — recent-point
culling, triangulation against the covisible neighbours, the two-way fuse
of duplicate points, local BA and keyframe culling — over the SoA
`MapState`. The JAX version compiles the pass into one program with
`lax.cond`; here its branches are Python `if`s on values read from the
device.

Duplicate-index writes: every scatter of the JAX pass that may hit a slot
twice is an order-free reduction here (`scatter_reduce` amax / amin on
integers), and every `.set` sends its masked rows to a spare row that is
cut off (`mapstate.set_rows`), so results do not depend on the order in
which the card applies writes. The JAX version sends some masked rows to
slot K-1 instead; the two differ only when keyframe slot K-1 is live, which
keyframe creation never allows (it needs n_kf < K-1).
"""

from __future__ import annotations

import numpy as np
import torch

from ..geometry import projection
from ..ops import hamming, matching
from ..optim import local_ba
from ..slammap import mapstate as ms

C_CAP = 48  # max local cameras in a BA window
L_CAP = 4096  # max points in a local BA window
O_BA = 8  # observation lanes per point fed to the BA (of ms.MAX_OBS)
O_BA_ESC = 16  # lane count when an in-window observation lies past O_BA

FUSE_CAP = 4096  # candidate points per fuse pass
N_REV_FUSE = 3  # close neighbours receiving the reverse (current->target) fuse
N_CULL_TARGETS = 32  # candidate window for keyframe culling

lm_chi2_mono = 5.99  # ORBmatcher.cc:905 (Fuse mono gate)
lm_chi2_stereo = 7.8  # ORBmatcher.cc:929 (Fuse stereo gate)

_I32 = torch.int32
_BIG_ROW = 1 << 30


def _clip0(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(x, min=0).long()


def _top_k(x: torch.Tensor, k: int):
    """`jax.lax.top_k`: the k largest along the last axis, ties to the
    lower index (a stable descending sort)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k].to(_I32)


def _scatter_max(n: int, idx: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """zeros(n).at[idx].max(vals) for non-negative int vals: order-free."""
    out = torch.zeros(n, dtype=_I32, device=idx.device)
    return out.scatter_reduce(0, idx.long(), vals.to(_I32), reduce="amax")


def _first_row(n: int, idx: torch.Tensor, live: torch.Tensor) -> torch.Tensor:
    """full(n, 2^30).at[idx].min(row) over the live rows: each slot's first
    row. Dead rows go to slot n-1 with the 2^30 sentinel, as in the JAX
    version."""
    rows = torch.arange(idx.shape[0], dtype=_I32, device=idx.device)
    out = torch.full((n,), _BIG_ROW, dtype=_I32, device=idx.device)
    return out.scatter_reduce(0, torch.where(live, idx, n - 1).long(),
                              torch.where(live, rows, _BIG_ROW), reduce="amin")


def recent_point_culling(state: ms.MapState, recent_mask: torch.Tensor,
                         current_kf, is_mono: bool = False) -> ms.MapState:
    """Cull recently created points (`src/LocalMapping.cc:170-205`):
    found/visible < 0.25, or too few observations two KFs after creation."""
    ratio = state.pt_found.to(torch.float32) / torch.clamp(
        state.pt_visible.to(torch.float32), min=1.0)
    obs = ms.point_obs_count(state)
    th_obs = 2 if is_mono else 3
    age = current_kf - state.pt_first_kf  # in KF slots (monotone allocation)
    bad = recent_mask & state.pt_valid & ((ratio < 0.25) | ((age >= 2) & (obs <= th_obs)))
    return ms.erase_points(state, bad)


def build_ba_window(state: ms.MapState, kf_slot: int) -> dict:
    """The BA window (`src/Optimizer.cc:456-504`): local cams = kf_slot +
    its covisible KFs (weight > 0, capped), local points = points they
    observe, fixed cams = up to 16 other observers of local points; slot 0
    is always fixed (the gauge)."""
    K = state.kf_capacity
    dev = state.device
    ncap = min(C_CAP, K)
    w = torch.where(state.kf_valid, state.covis[kf_slot], 0)
    w[kf_slot] = 0
    top_w, top_kf = _top_k(w, ncap - 1)
    local_kf = torch.cat([torch.tensor([kf_slot], dtype=_I32, device=dev), top_kf])
    local_ok = torch.cat([torch.ones(1, dtype=torch.bool, device=dev), top_w > 0])

    pts_of = torch.where(local_ok[:, None], state.kf_kp_point[local_kf.long()], -1)
    flat = pts_of.reshape(-1)
    pt_flag = _scatter_max(state.pt_capacity, torch.clamp(flat, min=0), flat >= 0)
    pt_flag = torch.where(state.pt_valid, pt_flag, 0)
    lidx = ms.compact_indices(pt_flag, min(L_CAP, state.pt_capacity))
    l_ok = lidx >= 0

    obs_kf = state.pt_obs_kf[_clip0(lidx)]  # (L,O)
    obs_ok = l_ok[:, None] & (obs_kf >= 0)
    in_local = ms.set_rows(torch.zeros(K, dtype=torch.bool, device=dev),
                           local_kf, local_ok, local_ok)
    fixed_flag = _scatter_max(K, torch.where(obs_ok, obs_kf, K - 1).reshape(-1),
                              obs_ok.reshape(-1))
    fixed_flag = torch.where(in_local | ~state.kf_valid, 0, fixed_flag)
    n_fixed_cap = min(16, ncap)
    _, fidx = _top_k(fixed_flag, n_fixed_cap)
    f_ok = fixed_flag[fidx.long()] > 0

    cam_slots = torch.cat([torch.where(local_ok, local_kf, -1),
                           torch.where(f_ok, fidx, -1)])
    cam_is_fixed = torch.cat([torch.zeros(ncap, dtype=torch.bool, device=dev),
                              torch.ones(n_fixed_cap, dtype=torch.bool, device=dev)])
    cam_is_fixed = cam_is_fixed | (cam_slots == 0)
    cam_ok = cam_slots >= 0
    C = cam_slots.shape[0]
    slot2cam = ms.set_rows(torch.full((K,), -1, dtype=_I32, device=dev), cam_slots,
                           torch.arange(C, dtype=_I32, device=dev), cam_ok)
    return dict(cam_slots=cam_slots, cam_is_fixed=cam_is_fixed, cam_ok=cam_ok,
                lidx=lidx, l_ok=l_ok, slot2cam=slot2cam)


def count_truncated_ba_lanes(state: ms.MapState, win: dict, n_lanes: int) -> torch.Tensor:
    """Observations of window points in lanes >= n_lanes whose observing KF
    is a window camera: constraints an n_lanes-wide problem drops."""
    lidx, l_ok, slot2cam = win["lidx"], win["l_ok"], win["slot2cam"]
    o_kf = state.pt_obs_kf[:, n_lanes:][_clip0(lidx)]
    ok = l_ok[:, None] & (o_kf >= 0) & (slot2cam[_clip0(o_kf)] >= 0)
    return torch.sum(ok.to(_I32))


def assemble_ba_obs(state: ms.MapState, win: dict, inv_level_sigma2: torch.Tensor,
                    n_lanes: int) -> local_ba.BAProblem:
    """The BAProblem over the window's first n_lanes observation lanes."""
    cam_slots, lidx, l_ok = win["cam_slots"], win["lidx"], win["l_ok"]
    li = _clip0(lidx)
    o_kf = state.pt_obs_kf[:, :n_lanes][li]
    o_ix = state.pt_obs_idx[:, :n_lanes][li]
    o_ok = l_ok[:, None] & (o_kf >= 0)
    o_cam = torch.where(o_ok, win["slot2cam"][_clip0(o_kf)], -1)
    o_ok = o_ok & (o_cam >= 0)
    k, f = _clip0(o_kf), _clip0(o_ix)
    octv = state.kf_kp_octave[k, f]
    is2 = inv_level_sigma2[torch.clamp(octv, 0, inv_level_sigma2.shape[0] - 1).long()]
    return local_ba.BAProblem(
        cam_pose=state.kf_pose[_clip0(cam_slots)], cam_fixed=win["cam_is_fixed"],
        cam_valid=win["cam_ok"], pt_pos=state.pt_pos[li], pt_valid=l_ok,
        obs_cam=o_cam, obs_uv=state.kf_kp_xy[k, f], obs_ur=state.kf_kp_ur[k, f],
        obs_inv_sigma2=is2, obs_valid=o_ok)


def apply_ba_result(state: ms.MapState, res: local_ba.BAResult, cam_slots: torch.Tensor,
                    lidx: torch.Tensor, prob: local_ba.BAProblem) -> ms.MapState:
    """Write back the optimized poses and points; erase the outlier
    observations, forward and reverse (`src/Optimizer.cc:717-779`). The
    problem's lanes are the first pt_obs lanes, so the reverse erase is a
    direct (point, lane) write."""
    l_ok = lidx >= 0
    safe_l = torch.where(l_ok, lidx, state.pt_capacity - 1)
    state = state._replace(
        kf_pose=ms.set_rows(state.kf_pose, cam_slots, res.cam_pose,
                            (cam_slots >= 0) & ~prob.cam_fixed),
        pt_pos=ms.set_rows(state.pt_pos, lidx, res.pt_pos, l_ok))
    out = prob.obs_valid & ~res.obs_inlier  # (L,O)
    O = out.shape[1]
    o_kf = state.pt_obs_kf[:, :O][safe_l.long()]
    o_ix = state.pt_obs_idx[:, :O][safe_l.long()]
    out = out & (o_kf >= 0) & l_ok[:, None]
    minus1 = torch.full(out.shape, -1, dtype=_I32, device=out.device)
    lanes = torch.arange(O, device=out.device).expand(out.shape)
    rows = safe_l[:, None].expand(out.shape)
    return state._replace(
        kf_kp_point=ms.set_rows(state.kf_kp_point, o_kf, minus1, out, _clip0(o_ix)),
        pt_obs_kf=ms.set_rows(state.pt_obs_kf, rows, minus1, out, lanes),
        pt_obs_idx=ms.set_rows(state.pt_obs_idx, rows, minus1, out, lanes))


def fuse_match(state: ms.MapState, kf: int, cand_idx: torch.Tensor,
               cam: projection.Camera, bounds: torch.Tensor, scale_factors: torch.Tensor,
               inv_level_sigma2: torch.Tensor, n_levels: int, scale_factor: float,
               th: float = 3.0) -> torch.Tensor:
    """The matching half of `ORBmatcher::Fuse` (`src/ORBmatcher.cc:828-978`):
    project the candidates into kf; per feature the best candidate within
    th * scale passing the chi2 and Hamming <= TH_LOW gates. No state
    change. Returns (N,) candidate row or -1."""
    safe = _clip0(cand_idx)
    cand_ok = (cand_idx >= 0) & state.pt_valid[safe]
    ok, uv, ur_pred, dist, _ = matching.frustum_check(
        cam, state.kf_pose[kf], state.pt_pos[safe], state.pt_normal[safe],
        state.pt_min_dist[safe], state.pt_max_dist[safe], bounds)
    ok = ok & cand_ok & ~(state.pt_obs_kf[safe] == kf).any(-1)  # not yet in kf
    lvl = matching.predict_scale(dist, state.pt_max_dist[safe], scale_factor, n_levels)
    radius = th * scale_factors[lvl.long()]
    kxy, koct, kur = state.kf_kp_xy[kf], state.kf_kp_octave[kf], state.kf_kp_ur[kf]
    d2 = matching._pair_d2(uv, kxy)
    in_win = d2 <= (radius[:, None] ** 2)
    oct_ok = (koct[None, :] >= (lvl - 1)[:, None]) & (koct[None, :] <= lvl[:, None])
    # reprojection chi2 gate at the feature's sigma (ORBmatcher.cc:905-933)
    is2 = inv_level_sigma2[torch.clamp(koct, 0, n_levels - 1).long()][None, :]
    er2 = (ur_pred[:, None] - kur[None, :]) ** 2
    gate = torch.where((kur >= 0)[None, :], (d2 + er2) * is2 <= lm_chi2_stereo,
                       d2 * is2 <= lm_chi2_mono)
    mask = in_win & oct_ok & state.kf_kp_valid[kf][None, :] & ok[:, None] & gate
    dmat = hamming.hamming_matrix_bits(hamming.unpack_bits(state.pt_desc[safe]),
                                       hamming.unpack_bits(state.kf_desc[kf]))
    idx, best, _ = hamming.masked_best2(dmat, extra_mask=mask)
    good = ok & (best <= hamming.TH_LOW)
    return matching._resolve_conflicts(idx, best, good, kxy.shape[0])


def fuse_apply(state: ms.MapState, kf: int, cand_idx: torch.Tensor, win: torch.Tensor,
               prefer_candidate: bool = False) -> ms.MapState:
    """The mutation half of Fuse: merge a matched candidate with the
    feature's existing point (the more-observed one is kept, ties keep the
    candidate, `src/ORBmatcher.cc:950-955`; the candidate always wins with
    prefer_candidate, the loop-fusion variant) or add it as a new
    observation. Candidates are re-validated against the current state."""
    cand_pt = torch.where(win >= 0, cand_idx[_clip0(win)], -1)
    cand_pt = torch.where((cand_pt >= 0) & state.pt_valid[_clip0(cand_pt)], cand_pt, -1)
    existing = state.kf_kp_point[kf]
    obs_cnt = ms.point_obs_count(state)
    obs_exist = obs_cnt[_clip0(existing)]
    merge = (cand_pt >= 0) & (existing >= 0) & (existing != cand_pt)
    if prefer_candidate:
        keep_exist = torch.zeros_like(merge)
    else:
        keep_exist = obs_exist > obs_cnt[_clip0(cand_pt)]
    src = torch.where(merge, torch.where(keep_exist, cand_pt, existing), -1)
    dst = torch.where(merge, torch.where(keep_exist, existing, cand_pt), -1)
    state = ms.merge_points(state, src, dst, merge)
    feat = torch.arange(existing.shape[0], dtype=_I32, device=existing.device)
    return ms.add_observations(state, kf, cand_pt, feat, (cand_pt >= 0) & (existing < 0))


def fuse_into_keyframe(state: ms.MapState, kf: int, cand_idx: torch.Tensor,
                       cam: projection.Camera, bounds, scale_factors, inv_level_sigma2,
                       n_levels: int, scale_factor: float, th: float = 3.0,
                       prefer_candidate: bool = False) -> ms.MapState:
    """`ORBmatcher::Fuse` into one keyframe: match + apply. cand_idx: (L,)
    unique point slots, -1 padded."""
    win = fuse_match(state, kf, cand_idx, cam, bounds, scale_factors,
                     inv_level_sigma2, n_levels, scale_factor, th)
    return fuse_apply(state, kf, cand_idx, win, prefer_candidate)


def keyframe_culling(state: ms.MapState, kf_slot: int) -> ms.MapState:
    """Cull redundant covisible KFs of kf_slot (`src/LocalMapping.cc:
    632-698`): a KF among the top-32 covisibles is erased when > 90% of its
    points are seen by >= 3 other KFs at the same or finer scale (+1
    octave). Culled KFs keep their slot (kf_valid False); their children
    re-parent to their best covisible earlier KF, else the grandparent;
    points anchored to a culled KF re-anchor to their first observer."""
    K, N = state.kf_kp_point.shape
    dev = state.device
    n_bins = 8
    T = min(N_CULL_TARGETS, K)
    w = torch.where(state.kf_valid, state.covis[kf_slot], 0)
    w[0] = 0
    w[kf_slot] = 0
    top_w, tgt = _top_k(w, T)
    tgt_ok = top_w > 0

    # per-point cumulative octave histogram: cum[p,c] = #observers, octave <= c
    obs_ok = state.pt_obs_kf >= 0
    o_oct = torch.clamp(state.pt_obs_oct.to(_I32), 0, n_bins - 1)
    onehot = (o_oct[..., None] == torch.arange(n_bins, device=dev)) & obs_ok[..., None]
    cum = torch.cumsum(torch.sum(onehot.to(_I32), dim=1), dim=-1)

    tgt_l = _clip0(tgt)
    pts = state.kf_kp_point[tgt_l]  # (T,N)
    ok = (pts >= 0) & tgt_ok[:, None]
    bin_ = torch.clamp(state.kf_kp_octave[tgt_l] + 1, 0, n_bins - 1)
    n_leq = cum[_clip0(pts), bin_.long()]  # includes the KF itself
    n_pts = torch.sum(ok.to(_I32), -1)
    n_red = torch.sum((ok & (n_leq - 1 >= 3)).to(_I32), -1)
    cull_t = tgt_ok & (n_pts > 0) & (n_red.to(torch.float32) > 0.9 * n_pts.to(torch.float32))
    if not bool(cull_t.any()):
        return state
    cull = ms.set_rows(torch.zeros(K, dtype=torch.bool, device=dev), tgt, cull_t, cull_t)

    parent = state.kf_parent
    pp = _clip0(parent)
    parent_is_culled = (parent >= 0) & cull[pp]
    slot_ids = torch.arange(K, device=dev)
    cand_ok = state.kf_valid[None, :] & ~cull[None, :] & (slot_ids[None, :] < slot_ids[:, None])
    w_cand = torch.where(cand_ok, state.covis, -1)
    best_cov = torch.argmax(w_cand, dim=1).to(_I32)
    has_cov = torch.gather(w_cand, 1, best_cov[:, None].long())[:, 0] > 0
    grand = state.kf_parent[pp]
    new_parent = torch.where(parent_is_culled, torch.where(has_cov, best_cov, grand), parent)

    culled_ids = torch.where(cull_t, tgt, -2)  # -2 never matches
    obs_culled = (state.pt_obs_kf[..., None] == culled_ids).any(-1)
    pt_obs_kf = torch.where(obs_culled, -1, state.pt_obs_kf)
    ref_culled = (state.pt_ref_kf >= 0) & cull[_clip0(state.pt_ref_kf)]
    has_obs = (pt_obs_kf >= 0).any(-1)
    first_lane = torch.argmax((pt_obs_kf >= 0).to(torch.int8), dim=-1)
    fallback = torch.gather(pt_obs_kf, 1, first_lane[:, None])[:, 0]
    return state._replace(
        kf_valid=state.kf_valid & ~cull,
        kf_kp_point=torch.where(cull[:, None], -1, state.kf_kp_point),
        kf_parent=new_parent,
        covis=torch.where(cull[:, None] | cull[None, :], 0, state.covis),
        pt_obs_kf=pt_obs_kf,
        pt_obs_idx=torch.where(obs_culled, -1, state.pt_obs_idx),
        pt_obs_oct=torch.where(obs_culled, torch.full_like(state.pt_obs_oct, -1),
                               state.pt_obs_oct),
        pt_ref_kf=torch.where(ref_culled & has_obs, fallback, state.pt_ref_kf))


class LocalMapper:
    """Runs the mapping stage from the host (the `LocalMapping::Run` loop body,
    `src/LocalMapping.cc:47-112`, minus the thread)."""

    def __init__(self, cam: projection.Camera, inv_level_sigma2, is_mono: bool = False,
                 scale_factors=None, n_levels: int = 4, scale_factor: float = 1.5):
        from . import triangulation as tri_mod

        self.cam = cam
        self.inv_level_sigma2 = np.asarray(inv_level_sigma2, np.float32)
        self.is_mono = is_mono
        # 10 stereo/RGB-D, 20 mono (LocalMapping.cc:210-212)
        self.n_tri_neighbors = 20 if is_mono else 10
        self.n_levels = n_levels
        self.scale_factor = scale_factor
        self.recent_start: int | None = None  # first "recent" point slot
        self.ba_lane_log: list[tuple[int, bool]] = []  # (dropped, escalated)
        if scale_factors is None:
            scale_factors = [scale_factor**i for i in range(n_levels)]
        self.scale_factors = np.asarray(scale_factors, np.float32)
        self.bounds = projection.compute_image_bounds(cam)
        self.tri = tri_mod.make_triangulator(
            cam, self.scale_factors, 1.0 / self.inv_level_sigma2,
            n_levels, scale_factor, is_mono)
        self._tables: dict = {}

    def _t(self, dev) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(inv_level_sigma2, scale_factors, bounds) on device dev."""
        if dev not in self._tables:
            self._tables[dev] = tuple(torch.from_numpy(a).to(dev) for a in (
                self.inv_level_sigma2, self.scale_factors, self.bounds))
        return self._tables[dev]

    def _ba(self, state: ms.MapState, kf_slot: int, abort: bool):
        """Local BA over the O_BA-lane window, rebuilt at O_BA_ESC lanes
        when any in-window observation lies past lane O_BA (the reference
        consumes every observation, `src/Optimizer.cc:507-556`). Returns
        (state, lanes still dropped, escalated)."""
        inv_ls2 = self._t(state.device)[0]
        win = build_ba_window(state, kf_slot)
        escalate = int(count_truncated_ba_lanes(state, win, O_BA)) > 0
        dropped = int(count_truncated_ba_lanes(state, win, O_BA_ESC)) if escalate else 0
        prob = assemble_ba_obs(state, win, inv_ls2, O_BA_ESC if escalate else O_BA)
        res = local_ba.local_bundle_adjustment(self.cam, prob, abort=abort)
        state = apply_ba_result(state, res, win["cam_slots"], win["lidx"], prob)
        return state, dropped, escalate

    def _reverse_fuse(self, state: ms.MapState, kf_slot: int, neigh: torch.Tensor):
        """Direction 2 of `SearchInNeighbors` (`src/LocalMapping.cc:505-518`):
        match the new keyframe's points into each of the N_REV_FUSE closest
        neighbours, then apply every target's merges in ONE merge_points and
        its new observations in ONE add_observations_rows_dup. Pairs are
        deduplicated as in the JAX version: one merge per src (first target
        wins), one per dst, none whose dst is a src elsewhere, and one new
        lane per (target, point)."""
        cam, n_levels, sf = self.cam, self.n_levels, self.scale_factor
        inv_ls2, scale_t, bounds_t = self._t(state.device)
        P = state.pt_capacity
        own_pts = state.kf_kp_point[kf_slot]  # (N,)
        N = own_pts.shape[0]
        n_rev = min(N_REV_FUSE, int(neigh.shape[0]))
        nb_host = neigh[:n_rev].tolist()
        wins = torch.stack([
            fuse_match(state, nb, own_pts, cam, bounds_t, scale_t, inv_ls2, n_levels, sf)
            if nb >= 0 else torch.full((N,), -1, dtype=_I32, device=state.device)
            for nb in nb_host])  # (R,N)

        nb_rows = neigh[:n_rev, None].expand(n_rev, N).reshape(-1)
        feat_rows = torch.arange(N, dtype=_I32, device=state.device).repeat(n_rev)
        wflat = wins.reshape(-1)
        cand_pt = torch.where(wflat >= 0, own_pts[_clip0(wflat)], -1)
        cand_pt = torch.where((cand_pt >= 0) & (nb_rows >= 0)
                              & state.pt_valid[_clip0(cand_pt)], cand_pt, -1)
        existing = state.kf_kp_point[_clip0(nb_rows), feat_rows.long()]  # (R*N,)
        # merge rule per pair (keep the more-observed point), pre-state counts
        obs_cnt = ms.point_obs_count(state)
        mergeable = (cand_pt >= 0) & (existing >= 0) & (existing != cand_pt)
        keep_exist = obs_cnt[_clip0(existing)] > obs_cnt[_clip0(cand_pt)]
        src = torch.where(mergeable, torch.where(keep_exist, cand_pt, existing), -1)
        dst = torch.where(mergeable, torch.where(keep_exist, existing, cand_pt), -1)
        rows = torch.arange(src.shape[0], dtype=_I32, device=state.device)
        is_first = (src >= 0) & (_first_row(P, src, src >= 0)[_clip0(src)] == rows)
        src_flag = ms.set_rows(torch.zeros(P, dtype=torch.bool, device=state.device),
                               src, torch.ones_like(mergeable), src >= 0)
        dst_first = (dst >= 0) & (_first_row(P, dst, dst >= 0)[_clip0(dst)] == rows)
        ok_pair = is_first & dst_first & ~src_flag[_clip0(dst)]
        state = ms.merge_points(state, torch.where(ok_pair, src, -1),
                                torch.where(ok_pair, dst, -1), ok_pair)
        # new observations where the target feature had no point; one lane
        # per (target, point): within a target the first feature wins
        addable = (cand_pt >= 0) & (existing < 0) & state.pt_valid[_clip0(cand_pt)]
        blk = torch.div(rows, N, rounding_mode="floor")
        key = blk * P + cand_pt
        first_of_pair = _first_row(n_rev * P + 1, torch.where(addable, key, n_rev * P),
                                   addable)
        addable = addable & (first_of_pair[torch.clamp(key, 0, n_rev * P).long()] == rows)
        return ms.add_observations_rows_dup(state, nb_rows, torch.where(addable, cand_pt, -1),
                                            feat_rows, addable)

    def _map_step(self, state: ms.MapState, kf_slot: int, recent_start: int,
                  abort: bool):
        """One `LocalMapping::Run` loop body: culling -> triangulation ->
        connections -> two-way fuse -> BA -> KF culling. Returns (state,
        BA lanes dropped, BA escalated)."""
        cam, n_levels, sf = self.cam, self.n_levels, self.scale_factor
        inv_ls2, scale_t, bounds_t = self._t(state.device)
        P = state.pt_capacity
        slots = torch.arange(P, device=state.device)
        recent = (slots >= recent_start) & (slots < state.n_pt)
        state = recent_point_culling(state, recent, kf_slot, self.is_mono)

        neigh = ms.covisible_keyframes(state, kf_slot, self.n_tri_neighbors)
        state, new = self.tri.batched(state, kf_slot, neigh)
        state = self.tri.finalize_idx(state, torch.clamp(new, min=0), new >= 0)
        state = ms.update_connections(state, kf_slot)

        # `SearchInNeighbors` (`src/LocalMapping.cc:454-534`), target ->
        # current: fuse the neighbourhood's points into the new keyframe
        pts_nb = torch.where((neigh >= 0)[:, None], state.kf_kp_point[_clip0(neigh)], -1)
        cand = ms.unique_compact_ids(pts_nb.reshape(-1), P, min(FUSE_CAP, P), state.pt_valid)
        state = fuse_into_keyframe(state, kf_slot, cand, cam, bounds_t, scale_t,
                                   inv_ls2, n_levels, sf)
        state = self._reverse_fuse(state, kf_slot, neigh)
        # refresh the fused points' descriptors / normals + connections
        # (`src/LocalMapping.cc:521-532`)
        own = state.kf_kp_point[kf_slot]
        state = ms.compute_distinctive_descriptors_idx(state, torch.clamp(own, min=0), own >= 0)
        state = ms.update_normal_and_depth_idx(state, torch.clamp(own, min=0), own >= 0,
                                               self.scale_factors, n_levels)
        state = ms.update_connections(state, kf_slot)

        if int(torch.sum(state.kf_valid.to(_I32))) <= 2:
            return state, 0, False
        state, dropped, esc = self._ba(state, kf_slot, abort)
        state = keyframe_culling(state, kf_slot)
        return state, dropped, esc

    def process(self, state: ms.MapState, kf_slot: int, abort: bool = False) -> ms.MapState:
        """One mapping iteration for a freshly inserted keyframe."""
        if self.recent_start is None:
            self.recent_start = 0
        new_state, dropped, esc = self._map_step(state, int(kf_slot), self.recent_start, abort)
        self.ba_lane_log.append((dropped, esc))
        # advance the recent window: points older than this keyframe leave
        self.recent_start = int(state.n_pt)
        return new_state

    def ba_lane_stats(self) -> tuple[int, int]:
        """(BA observation lanes dropped, escalated steps) over every
        mapping step logged by `process`."""
        return (sum(d for d, _ in self.ba_lane_log),
                sum(int(e) for _, e in self.ba_lane_log))
