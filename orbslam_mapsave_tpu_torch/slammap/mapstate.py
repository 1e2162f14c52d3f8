"""Fixed-capacity structure-of-arrays SLAM map state.

Port of `orbslam_mapsave_tpu/slammap/mapstate.py` (all of it but the
whole-map `compute_distinctive_descriptors` / `update_normal_and_depth`,
whose `_idx` forms the paths call): the reference's pointer-graph map
(`Map` + `KeyFrame` + `MapPoint`) as ONE NamedTuple of padded tensors with
validity masks.
Object identity = array slot. Updates are functional — every function
returns a new MapState and leaves its input untouched, as in the JAX
version — so callers can keep or drop a candidate state on the host.

Scatters: the JAX version routes dead rows to an out-of-range index with
`mode="drop"`. Here `set_rows` does the same explicitly: it writes into a
copy with one spare row, sends masked rows there, and cuts it off. No
index ever wraps around.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..geometry import se3

MAX_OBS = 32  # per-point observation capacity
MAX_LOOP_EDGES = 8
COVIS_MIN_WEIGHT = 15  # KeyFrame.cc:1051


class MapState(NamedTuple):
    # --- keyframes ---
    kf_pose: torch.Tensor  # (K,4,4) f32 Tcw
    kf_valid: torch.Tensor  # (K,) bool
    kf_timestamp: torch.Tensor  # (K,) f32 offset from the run's f64 epoch
    kf_frame_id: torch.Tensor  # (K,) i32
    kf_kp_xy: torch.Tensor  # (K,N,2) f32 undistorted
    kf_kp_ur: torch.Tensor  # (K,N) f32, <0 = mono
    kf_kp_depth: torch.Tensor  # (K,N) f32, <=0 = none
    kf_kp_octave: torch.Tensor  # (K,N) i32
    kf_kp_angle: torch.Tensor  # (K,N) f32 degrees
    kf_kp_valid: torch.Tensor  # (K,N) bool
    kf_desc: torch.Tensor  # (K,N,32) u8
    kf_kp_point: torch.Tensor  # (K,N) i32 point slot or -1
    # --- map points ---
    pt_pos: torch.Tensor  # (P,3) f32
    pt_valid: torch.Tensor  # (P,) bool
    pt_desc: torch.Tensor  # (P,32) u8
    pt_normal: torch.Tensor  # (P,3) f32
    pt_min_dist: torch.Tensor  # (P,) f32
    pt_max_dist: torch.Tensor  # (P,) f32
    pt_ref_kf: torch.Tensor  # (P,) i32
    pt_first_kf: torch.Tensor  # (P,) i32
    pt_visible: torch.Tensor  # (P,) i32
    pt_found: torch.Tensor  # (P,) i32
    pt_obs_kf: torch.Tensor  # (P,MAX_OBS) i32, -1 pad
    pt_obs_idx: torch.Tensor  # (P,MAX_OBS) i32
    pt_obs_oct: torch.Tensor  # (P,MAX_OBS) i8, -1 pad
    # --- graph ---
    covis: torch.Tensor  # (K,K) i32
    kf_parent: torch.Tensor  # (K,) i32
    kf_loop_edges: torch.Tensor  # (K,MAX_LOOP_EDGES) i32
    # --- counters (0-dim i32) ---
    n_kf: torch.Tensor
    n_pt: torch.Tensor
    n_obs_dropped: torch.Tensor

    @property
    def kf_capacity(self) -> int:
        return self.kf_pose.shape[0]

    @property
    def pt_capacity(self) -> int:
        return self.pt_pos.shape[0]

    @property
    def n_features(self) -> int:
        return self.kf_kp_xy.shape[1]

    @property
    def device(self) -> torch.device:
        return self.kf_pose.device


def empty_map(max_keyframes: int, max_points: int, n_features: int,
              device="cpu") -> MapState:
    K, P, N = max_keyframes, max_points, n_features
    host = dict(
        kf_pose=np.tile(np.eye(4, dtype=np.float32), (K, 1, 1)),
        kf_valid=np.zeros(K, bool),
        kf_timestamp=np.zeros(K, np.float32),
        kf_frame_id=np.zeros(K, np.int32),
        kf_kp_xy=np.zeros((K, N, 2), np.float32),
        kf_kp_ur=np.full((K, N), -1.0, np.float32),
        kf_kp_depth=np.zeros((K, N), np.float32),
        kf_kp_octave=np.zeros((K, N), np.int32),
        kf_kp_angle=np.zeros((K, N), np.float32),
        kf_kp_valid=np.zeros((K, N), bool),
        kf_desc=np.zeros((K, N, 32), np.uint8),
        kf_kp_point=np.full((K, N), -1, np.int32),
        pt_pos=np.zeros((P, 3), np.float32),
        pt_valid=np.zeros(P, bool),
        pt_desc=np.zeros((P, 32), np.uint8),
        pt_normal=np.zeros((P, 3), np.float32),
        pt_min_dist=np.zeros(P, np.float32),
        pt_max_dist=np.zeros(P, np.float32),
        pt_ref_kf=np.full(P, -1, np.int32),
        pt_first_kf=np.full(P, -1, np.int32),
        pt_visible=np.ones(P, np.int32),
        pt_found=np.ones(P, np.int32),
        pt_obs_kf=np.full((P, MAX_OBS), -1, np.int32),
        pt_obs_idx=np.full((P, MAX_OBS), -1, np.int32),
        pt_obs_oct=np.full((P, MAX_OBS), -1, np.int8),
        covis=np.zeros((K, K), np.int32),
        kf_parent=np.full(K, -1, np.int32),
        kf_loop_edges=np.full((K, MAX_LOOP_EDGES), -1, np.int32),
        n_kf=np.int32(0),
        n_pt=np.int32(0),
        n_obs_dropped=np.int32(0),
    )
    return MapState(**{k: torch.as_tensor(v).to(device) for k, v in host.items()})


def set_rows(arr: torch.Tensor, idx: torch.Tensor, vals, ok: torch.Tensor,
             lane: torch.Tensor | None = None) -> torch.Tensor:
    """Copy of `arr` with arr[idx[i]] (or arr[idx[i], lane[i]]) = vals[i]
    where ok[i]; rows with ok False are dropped (JAX `mode="drop"`). Live
    (idx, lane) pairs must be unique."""
    n = arr.shape[0]
    ext = torch.cat([arr, arr[:1]])
    row = torch.where(ok, idx, torch.full_like(idx, n)).long()
    if not torch.is_tensor(vals):
        vals = torch.tensor(vals, dtype=arr.dtype, device=arr.device)
    if lane is None:
        ext[row] = vals.to(arr.dtype)
    else:
        ext[row, lane.long()] = vals.to(arr.dtype)
    return ext[:n]


def add_rows(arr: torch.Tensor, idx: torch.Tensor, vals: torch.Tensor,
             ok: torch.Tensor) -> torch.Tensor:
    """Copy of `arr` with vals[i] added at arr[idx[i]] where ok[i]
    (duplicates accumulate; masked rows are dropped)."""
    n = arr.shape[0]
    ext = torch.cat([arr, arr[:1]])
    row = torch.where(ok, idx, torch.full_like(idx, n)).long()
    return ext.index_add(0, row, vals.to(arr.dtype))[:n]


# ---------------------------------------------------------------------------
# Keyframe / point allocation
# ---------------------------------------------------------------------------


def add_keyframe(state: MapState, pose_cw, timestamp, frame_id,
                 kp_xy, kp_ur, kp_depth, kp_octave, kp_angle, kp_valid, desc,
                 kp_point=None) -> tuple[MapState, int]:
    """Append a keyframe at slot n_kf; returns (state, slot) —
    `Tracking::CreateNewKeyFrame` + `Map::AddKeyFrame`. Capacity overflow is
    the caller's responsibility."""
    k = int(state.n_kf)
    if kp_point is None:
        kp_point = torch.full((state.n_features,), -1, dtype=torch.int32,
                              device=state.device)

    def put(arr, val):
        out = arr.clone()
        out[k] = torch.as_tensor(val, device=out.device).to(arr.dtype)
        return out

    state = state._replace(
        kf_pose=put(state.kf_pose, pose_cw),
        kf_valid=put(state.kf_valid, True),
        kf_timestamp=put(state.kf_timestamp, timestamp),
        kf_frame_id=put(state.kf_frame_id, frame_id),
        kf_kp_xy=put(state.kf_kp_xy, kp_xy),
        kf_kp_ur=put(state.kf_kp_ur, kp_ur),
        kf_kp_depth=put(state.kf_kp_depth, kp_depth),
        kf_kp_octave=put(state.kf_kp_octave, kp_octave),
        kf_kp_angle=put(state.kf_kp_angle, kp_angle),
        kf_kp_valid=put(state.kf_kp_valid, kp_valid),
        kf_desc=put(state.kf_desc, desc),
        kf_kp_point=put(state.kf_kp_point, kp_point),
        n_kf=state.n_kf + 1,
    )
    return state, k


def add_points(state: MapState, pos: torch.Tensor, desc: torch.Tensor,
               ref_kf, first_kf, valid_mask: torch.Tensor,
               normal=None, min_dist=None, max_dist=None
               ) -> tuple[MapState, torch.Tensor]:
    """Bulk-append B candidate points; masked rows are skipped. Slots are
    allocated compactly from n_pt by a prefix sum. Returns (state, slots
    (B,) i32, -1 where masked out or past capacity).

    Kept for parity with the JAX version, which sends every skipped row to
    slot P-1 with that slot's old value, applied in row order: the point
    written into the last slot is lost (the slot keeps its old contents)
    when a skipped row comes after it."""
    B = pos.shape[0]
    dev = pos.device
    i32 = torch.int32
    offs = torch.cumsum(valid_mask.to(i32), 0).to(i32) - 1
    minus1 = torch.full((B,), -1, dtype=i32, device=dev)
    slots = torch.where(valid_mask, state.n_pt + offs, minus1)
    cap = state.pt_capacity
    slots = torch.where(slots < cap, slots, minus1)
    ok = slots >= 0
    rows = torch.arange(B, device=dev)
    last_skipped = torch.cat([torch.where(ok, -1, rows), rows.new_full((1,), -1)]).max()
    write = ok & ~((slots == cap - 1) & (rows < last_skipped))

    def scat(arr, vals):
        return set_rows(arr, slots, vals, write)

    ref_kf = torch.as_tensor(ref_kf, dtype=i32, device=dev).expand(B)
    first_kf = torch.as_tensor(first_kf, dtype=i32, device=dev).expand(B)
    if normal is None:
        normal = torch.zeros((B, 3), dtype=pos.dtype, device=dev)
    if min_dist is None:
        min_dist = torch.zeros(B, dtype=pos.dtype, device=dev)
    if max_dist is None:
        max_dist = torch.full((B,), float("inf"), dtype=pos.dtype, device=dev)
    ones_i = torch.ones(B, dtype=i32, device=dev)
    lanes = torch.full((B, MAX_OBS), -1, dtype=i32, device=dev)
    state = state._replace(
        pt_pos=scat(state.pt_pos, pos),
        pt_valid=scat(state.pt_valid, torch.ones(B, dtype=torch.bool, device=dev)),
        pt_desc=scat(state.pt_desc, desc),
        pt_normal=scat(state.pt_normal, normal),
        pt_min_dist=scat(state.pt_min_dist, min_dist),
        pt_max_dist=scat(state.pt_max_dist, max_dist),
        pt_ref_kf=scat(state.pt_ref_kf, ref_kf),
        pt_first_kf=scat(state.pt_first_kf, first_kf),
        pt_visible=scat(state.pt_visible, ones_i),
        pt_found=scat(state.pt_found, ones_i),
        pt_obs_kf=scat(state.pt_obs_kf, lanes),
        pt_obs_idx=scat(state.pt_obs_idx, lanes),
        pt_obs_oct=scat(state.pt_obs_oct, lanes.to(torch.int8)),
        n_pt=torch.clamp(state.n_pt + torch.sum(valid_mask.to(i32)), max=cap).to(i32),
    )
    return state, slots


def add_observations(state: MapState, kf_slot: int, pt_slots: torch.Tensor,
                     feat_idx: torch.Tensor, ok: torch.Tensor) -> MapState:
    """Register point<->keyframe observations for a batch of features.

    Forward: kf_kp_point[kf, feat] = pt. Reverse: first free lane of
    pt_obs_kf[pt] (`MapPoint::AddObservation` + `KeyFrame::AddMapPoint`).
    pt_slots must be unique within a call; a point with no free lane is
    counted in n_obs_dropped."""
    return add_observations_rows(state, torch.full_like(pt_slots, int(kf_slot)),
                                 pt_slots, feat_idx, ok)


def _reverse_append(state: MapState, kf_rows: torch.Tensor, pt_slots: torch.Tensor,
                    feat_idx: torch.Tensor, okk: torch.Tensor,
                    lane: torch.Tensor, okf: torch.Tensor) -> MapState:
    """Shared tail of the add_observations variants: forward refs at
    (kf_rows, feat_idx) where okk, reverse entries at (pt_slots, lane) where
    okf, octaves copied from the keyframe; rows with okk but not okf count
    in n_obs_dropped."""
    K = state.kf_capacity
    safe_kf = torch.where(okk, kf_rows, torch.full_like(kf_rows, K - 1)).long()
    safe_ft = torch.where(okk, feat_idx,
                          torch.full_like(feat_idx, state.n_features - 1)).long()
    oct_b = state.kf_kp_octave[safe_kf, safe_ft].to(torch.int8)
    dropped = torch.sum((okk & ~okf).to(torch.int32))
    return state._replace(
        kf_kp_point=set_rows(state.kf_kp_point, kf_rows, pt_slots, okk, safe_ft),
        pt_obs_kf=set_rows(state.pt_obs_kf, pt_slots, kf_rows, okf, lane),
        pt_obs_idx=set_rows(state.pt_obs_idx, pt_slots, feat_idx, okf, lane),
        pt_obs_oct=set_rows(state.pt_obs_oct, pt_slots, oct_b, okf, lane),
        n_obs_dropped=(state.n_obs_dropped + dropped).to(torch.int32),
    )


def add_observations_rows(state: MapState, kf_rows: torch.Tensor,
                          pt_slots: torch.Tensor, feat_idx: torch.Tensor,
                          ok: torch.Tensor) -> MapState:
    """`add_observations` with a different keyframe per row (batched
    triangulation: each new point's second observation lives in the
    neighbour that produced the match). pt_slots and (kf, feat) pairs must
    be unique within a call."""
    P = state.pt_capacity
    okk = ok & (pt_slots >= 0) & (kf_rows >= 0)
    safe_pt = torch.where(okk, pt_slots, torch.full_like(pt_slots, P - 1)).long()
    free = state.pt_obs_kf[safe_pt] < 0  # (B,MAX_OBS)
    lane = torch.argmax(free.to(torch.int8), dim=-1)
    return _reverse_append(state, kf_rows, pt_slots, feat_idx, okk, lane,
                           okk & free.any(dim=-1))


def add_observations_rows_dup(state: MapState, kf_rows: torch.Tensor,
                              pt_slots: torch.Tensor, feat_idx: torch.Tensor,
                              ok: torch.Tensor) -> MapState:
    """`add_observations_rows` that permits repeated pt_slots: the rows of
    one point take its 1st, 2nd, ... free lanes in row order (rank within
    the point's group of a stable sort by slot). Needed by the combined
    reverse fuse, where a point may join several neighbours in one step.
    (kf, feat) pairs must still be unique. Past 4096 live rows the rest
    are dropped, as in the JAX version."""
    P = state.pt_capacity
    okk = ok & (pt_slots >= 0) & (kf_rows >= 0)
    cap = 4096
    if pt_slots.shape[0] > cap:
        sel = compact_indices(okk, cap)
        selok = sel >= 0
        ss = torch.clamp(sel, min=0).long()
        kf_rows = torch.where(selok, kf_rows[ss], torch.full_like(sel, -1))
        pt_slots = torch.where(selok, pt_slots[ss], torch.full_like(sel, -1))
        feat_idx = torch.where(selok, feat_idx[ss], torch.zeros_like(sel))
        okk = selok & (pt_slots >= 0) & (kf_rows >= 0)
    B = pt_slots.shape[0]
    idx = torch.arange(B, dtype=torch.int32, device=pt_slots.device)
    key = torch.where(okk, pt_slots, torch.full_like(pt_slots, P))
    sorted_key, order = torch.sort(key, stable=True)
    new_group = torch.cat([torch.ones_like(okk[:1]), sorted_key[1:] != sorted_key[:-1]])
    group_start = torch.cummax(torch.where(new_group, idx, torch.zeros_like(idx)), 0).values
    rank = torch.empty_like(idx)
    rank[order] = idx - group_start  # order is a permutation: unique writes
    safe_pt = torch.where(okk, pt_slots, torch.full_like(pt_slots, P - 1)).long()
    free = state.pt_obs_kf[safe_pt] < 0
    cumfree = torch.cumsum(free.to(torch.int32), dim=-1)
    hit = free & (cumfree == (rank + 1)[:, None])
    lane = torch.argmax(hit.to(torch.int8), dim=-1)
    return _reverse_append(state, kf_rows, pt_slots, feat_idx, okk, lane,
                           okk & hit.any(dim=-1))


def point_obs_count(state: MapState) -> torch.Tensor:
    """(P,) number of observations per point (`MapPoint::Observations`)."""
    return torch.sum((state.pt_obs_kf >= 0).to(torch.int32), dim=-1)


def compact_indices(flag: torch.Tensor, cap: int) -> torch.Tensor:
    """Indices of nonzero flags compacted into (cap,) ascending, -1 pad;
    flags past the first `cap` set bits are dropped."""
    n = flag.shape[0]
    f = (flag > 0).to(torch.int32)
    pos = torch.cumsum(f, 0).to(torch.int32) - f
    ok = (f > 0) & (pos < cap)
    out = torch.full((cap,), -1, dtype=torch.int32, device=flag.device)
    return set_rows(out, pos, torch.arange(n, dtype=torch.int32,
                                            device=flag.device), ok)


def unique_compact_ids(ids: torch.Tensor, sentinel: int, cap: int,
                       valid_of: torch.Tensor | None = None) -> torch.Tensor:
    """Unique valid ids compacted ascending into (cap,), -1 padded; past
    cap the largest ids drop. `sentinel` must exceed every valid id."""
    ok = ids >= 0
    if valid_of is not None:
        ok = ok & valid_of[torch.clamp(ids, min=0).long()]
    key = torch.sort(torch.where(ok, ids, torch.full_like(ids, sentinel))).values
    uniq = torch.cat([torch.ones_like(ok[:1]), key[1:] != key[:-1]]) & (key < sentinel)
    out = torch.sort(torch.where(uniq, key, torch.full_like(key, sentinel))).values[:cap]
    return torch.where(out < sentinel, out, torch.full_like(out, -1))


def erase_points(state: MapState, pt_mask: torch.Tensor) -> MapState:
    """Soft-delete points where pt_mask (`MapPoint::SetBadFlag`): validity,
    every forward reference and the reverse rows are cleared."""
    fwd = state.kf_kp_point
    bad_ref = (fwd >= 0) & pt_mask[torch.clamp(fwd, min=0).long()]
    m = pt_mask[:, None]
    return state._replace(
        pt_valid=state.pt_valid & ~pt_mask,
        kf_kp_point=torch.where(bad_ref, torch.full_like(fwd, -1), fwd),
        pt_obs_kf=torch.where(m, torch.full_like(state.pt_obs_kf, -1), state.pt_obs_kf),
        pt_obs_idx=torch.where(m, torch.full_like(state.pt_obs_idx, -1), state.pt_obs_idx),
        pt_obs_oct=torch.where(m, torch.full_like(state.pt_obs_oct, -1), state.pt_obs_oct),
    )


def replace_points(state: MapState, src: torch.Tensor, dst: torch.Tensor,
                   ok: torch.Tensor) -> MapState:
    """Fuse: every forward reference to src[i] is redirected to dst[i]
    (`MapPoint::Replace`, `src/MapPoint.cc`), src's visible / found counts
    are added to dst's, then src is erased. Live src slots must be unique.

    Reverse lists of dst are NOT extended lane-by-lane here; callers run
    `rebuild_observations` after a fuse batch, as in the JAX version."""
    P = state.pt_capacity
    dev = src.device
    src_c = torch.where(ok, src, torch.zeros_like(src)).long()
    redirect = set_rows(torch.arange(P, dtype=torch.int32, device=dev), src, dst, ok)
    fwd = state.kf_kp_point
    new_fwd = torch.where(fwd >= 0, redirect[torch.clamp(fwd, min=0).long()], fwd)
    # accumulate found/visible like MapPoint::Replace does
    vis = add_rows(state.pt_visible, dst, state.pt_visible[src_c], ok)
    fnd = add_rows(state.pt_found, dst, state.pt_found[src_c], ok)
    bad = set_rows(torch.zeros(P, dtype=torch.bool, device=dev), src, True, ok)
    state = state._replace(kf_kp_point=new_fwd, pt_visible=vis, pt_found=fnd)
    return erase_points(state, bad)


def rebuild_observations(state: MapState) -> MapState:
    """Recompute the reverse lists (pt_obs_kf / pt_obs_idx / pt_obs_oct)
    from the forward map — the functional replacement for the reference's
    incremental pointer surgery. O(K*N). Each point's observations take
    lanes in (keyframe, keypoint) order, at most MAX_OBS of them."""
    K, N = state.kf_kp_point.shape
    P = state.pt_capacity
    dev = state.kf_kp_point.device
    flat = state.kf_kp_point.reshape(-1).long()
    # lane = rank of the observation among its point's: stable sort by point
    keys = torch.where(flat >= 0, flat, torch.full_like(flat, P))
    sorted_keys, order = torch.sort(keys, stable=True)
    lane = torch.arange(K * N, device=dev) - torch.searchsorted(sorted_keys, sorted_keys)
    kf_of, ft_of = order // N, order % N
    ok = (sorted_keys < P) & (lane < MAX_OBS)
    lane = torch.where(ok, lane, torch.zeros_like(lane))

    def table(vals, dtype):
        return set_rows(torch.full((P, MAX_OBS), -1, dtype=dtype, device=dev),
                        sorted_keys, vals, ok, lane=lane)

    return state._replace(
        pt_obs_kf=table(kf_of, torch.int32), pt_obs_idx=table(ft_of, torch.int32),
        pt_obs_oct=table(state.kf_kp_octave[kf_of, ft_of], torch.int8))


def merge_points(state: MapState, src: torch.Tensor, dst: torch.Tensor,
                 ok: torch.Tensor, cap: int = 1024) -> MapState:
    """`MapPoint::Replace` parity: every observation of src[i] moves to
    dst[i]; where the observing KF already sees dst, the duplicate forward
    match is erased instead; src is soft-deleted and its visible/found
    counts add to dst's. src slots must be unique, dst slots unique and
    disjoint from src (the callers deduplicate). Past `cap` live pairs the
    rest wait for a later call, as in the JAX version."""
    P = state.pt_capacity
    K = state.kf_capacity
    ok = ok & (src >= 0) & (dst >= 0) & (src != dst)
    if src.shape[0] > cap:
        sel = compact_indices(ok, cap)
        selok = sel >= 0
        ss = torch.clamp(sel, min=0).long()
        src = torch.where(selok, src[ss], torch.full_like(sel, -1))
        dst = torch.where(selok, dst[ss], torch.full_like(sel, -1))
        ok = selok & (src >= 0)
    safe_src = torch.where(ok, src, torch.full_like(src, P - 1)).long()
    safe_dst = torch.where(ok, dst, torch.full_like(dst, P - 1)).long()
    s_kf = torch.where(ok[:, None], state.pt_obs_kf[safe_src],
                       torch.full_like(state.pt_obs_kf[safe_src], -1))  # (B,O)
    s_ix = state.pt_obs_idx[safe_src]
    s_oc = state.pt_obs_oct[safe_src]
    d_kf = state.pt_obs_kf[safe_dst]
    s_live = s_kf >= 0
    # src observations whose KF already observes dst are duplicates
    dup = ((s_kf[:, :, None] == d_kf[:, None, :]) & s_live[..., None]).any(-1)
    move = s_live & ~dup
    # forward pointers: moved -> dst, duplicates -> -1; (kf, feat) pairs of
    # live lanes are unique (src unique, forward map single-valued)
    tgt = torch.where(move, safe_dst[:, None].to(torch.int32),
                      torch.full_like(s_kf, -1))
    fwd = set_rows(state.kf_kp_point, s_kf, tgt, s_live, torch.clamp(s_ix, min=0))
    # dst rows: append the moved lanes, valid entries first (stable), cut
    # to MAX_OBS; what falls off counts in n_obs_dropped
    comb_kf = torch.cat([d_kf, torch.where(move, s_kf, torch.full_like(s_kf, -1))], 1)
    comb_ix = torch.cat([state.pt_obs_idx[safe_dst],
                         torch.where(move, s_ix, torch.full_like(s_ix, -1))], 1)
    comb_oc = torch.cat([state.pt_obs_oct[safe_dst],
                         torch.where(move, s_oc, torch.full_like(s_oc, -1))], 1)
    order = torch.argsort((comb_kf < 0).to(torch.int8), dim=1, stable=True)
    comb_kf = torch.gather(comb_kf, 1, order)
    n_dropped = torch.sum((comb_kf[:, MAX_OBS:] >= 0).to(torch.int32))
    comb_ix = torch.gather(comb_ix, 1, order)[:, :MAX_OBS]
    comb_oc = torch.gather(comb_oc, 1, order)[:, :MAX_OBS]
    comb_kf = comb_kf[:, :MAX_OBS]
    vis = state.pt_visible[safe_dst] + state.pt_visible[safe_src]
    fnd = state.pt_found[safe_dst] + state.pt_found[safe_src]
    src_mask = set_rows(torch.zeros(P, dtype=torch.bool, device=state.device),
                        src, torch.ones_like(ok), ok)
    m = src_mask[:, None]
    return state._replace(
        kf_kp_point=fwd,
        pt_obs_kf=torch.where(m, -1, set_rows(state.pt_obs_kf, dst, comb_kf, ok)),
        pt_obs_idx=torch.where(m, -1, set_rows(state.pt_obs_idx, dst, comb_ix, ok)),
        pt_obs_oct=torch.where(m, torch.full_like(state.pt_obs_oct, -1),
                               set_rows(state.pt_obs_oct, dst, comb_oc, ok)),
        pt_visible=set_rows(state.pt_visible, dst, vis, ok),
        pt_found=set_rows(state.pt_found, dst, fnd, ok),
        pt_valid=state.pt_valid & ~src_mask,
        n_obs_dropped=(state.n_obs_dropped + n_dropped).to(torch.int32),
    )


def update_connections(state: MapState, kf_slot: int) -> MapState:
    """Recompute the covisibility row/col of one KF + spanning-tree attach
    (`KeyFrame::UpdateConnections`, `src/KeyFrame.cc:1010-1100`): edges with
    weight >= 15, always the single best edge; on first connection,
    parent = top covisible KF."""
    K = state.kf_capacity
    pts = state.kf_kp_point[kf_slot]
    ok = pts >= 0
    safe = torch.where(ok, pts, torch.full_like(pts, state.pt_capacity - 1)).long()
    obs_kf = state.pt_obs_kf[safe]  # (N,MAX_OBS)
    obs_ok = ok[:, None] & (obs_kf >= 0)
    counts = torch.zeros(K, dtype=torch.int32, device=state.device)
    counts = add_rows(counts, obs_kf.reshape(-1),
                       torch.ones_like(obs_kf.reshape(-1)), obs_ok.reshape(-1))
    counts[kf_slot] = 0
    counts = torch.where(state.kf_valid, counts, torch.zeros_like(counts))
    best = torch.amax(counts)
    best_kf = torch.argmax(counts)
    row = torch.where(counts >= COVIS_MIN_WEIGHT, counts, torch.zeros_like(counts))
    row[best_kf] = torch.where(best > 0, best, torch.zeros_like(best))
    covis = state.covis.clone()
    covis[kf_slot, :] = row
    covis[:, kf_slot] = row
    cur_parent = state.kf_parent[kf_slot]
    need_parent = (cur_parent < 0) & (kf_slot != 0) & (best > 0)
    kf_parent = state.kf_parent.clone()
    kf_parent[kf_slot] = torch.where(need_parent, best_kf.to(torch.int32), cur_parent)
    return state._replace(covis=covis, kf_parent=kf_parent)


def covisible_keyframes(state: MapState, kf_slot, top_n: int) -> torch.Tensor:
    """Top-N covisible KF slots by weight (-1 padded), lowest slot first
    among equal weights (`KeyFrame::GetBestCovisibilityKeyFrames`)."""
    w = state.covis[kf_slot]
    vals, idx = torch.sort(w, descending=True, stable=True)
    vals, idx = vals[:top_n], idx[:top_n].to(torch.int32)
    return torch.where(vals > 0, idx, torch.full_like(idx, -1))


def _distinctive_descriptors_rows(obs_kf, obs_idx, kf_desc):
    """Min-median-Hamming descriptor for B points given their (B,O)
    observation rows. Returns (desc (B,32), has_obs (B,))."""
    B, O = obs_kf.shape
    ok = obs_kf >= 0
    descs = kf_desc[torch.clamp(obs_kf, min=0).long(),
                    torch.clamp(obs_idx, min=0).long()]  # (B,O,32)
    shifts = torch.arange(8, dtype=torch.uint8, device=descs.device)
    bits = ((descs[..., None] >> shifts) & 1).reshape(B, O, 256).to(torch.float32)
    pop = torch.sum(bits, -1).to(torch.int32)
    dot = torch.bmm(bits, bits.transpose(1, 2)).to(torch.int32)  # exact ints
    dist = pop[:, :, None] + pop[:, None, :] - 2 * dot
    big = 1 << 20
    dist = torch.where(ok[:, None, :] & ok[:, :, None], dist, torch.full_like(dist, big))
    cnt = torch.sum(ok.to(torch.int32), -1)
    sdist = torch.sort(dist, dim=-1).values
    mid = torch.clamp((cnt - 1) // 2, min=0)[:, None, None].expand(B, O, 1).long()
    med = torch.gather(sdist, -1, mid)[..., 0]
    med = torch.where(ok, med, torch.full_like(med, big))
    best = torch.argmin(med, dim=-1)
    new_desc = descs[torch.arange(B, device=descs.device), best]
    return new_desc, cnt > 0


def compute_distinctive_descriptors_idx(state: MapState, idx: torch.Tensor,
                                        idx_ok: torch.Tensor) -> MapState:
    """`MapPoint::ComputeDistinctiveDescriptors` for the B point slots in
    `idx` (masked by idx_ok; idx unique)."""
    P = state.pt_capacity
    safe = torch.where(idx_ok, idx, torch.full_like(idx, P - 1)).long()
    obs_kf = torch.where(idx_ok[:, None], state.pt_obs_kf[safe],
                         torch.full_like(state.pt_obs_kf[safe], -1))
    new_desc, has = _distinctive_descriptors_rows(
        obs_kf, state.pt_obs_idx[safe], state.kf_desc)
    return state._replace(
        pt_desc=set_rows(state.pt_desc, idx, new_desc, idx_ok & has))


def _normal_and_depth_rows(pt_pos, pt_ref_kf, obs_kf, obs_idx, kf_pose,
                           kf_kp_octave, scale_factors, n_levels: int):
    """Normal + distance band for B points given their (B,O) observation
    rows. Returns (normal (B,3), min_d (B,), max_d (B,), has_obs (B,))."""
    sf = torch.as_tensor(scale_factors, dtype=torch.float32, device=pt_pos.device)
    B, O = obs_kf.shape
    ok = obs_kf >= 0
    centers = se3.se3_inv(kf_pose)[:, :3, 3]  # (K,3)
    cams = centers[torch.clamp(obs_kf, min=0).long()]  # (B,O,3)
    diff = pt_pos[:, None, :] - cams
    norm = torch.clamp(torch.linalg.vector_norm(diff, dim=-1, keepdim=True), min=1e-12)
    units = diff / norm
    cnt = torch.clamp(torch.sum(ok.to(torch.int32), -1), min=1)
    normal = torch.sum(torch.where(ok[:, None], units.transpose(1, 2),
                                   torch.zeros_like(units.transpose(1, 2))), -1) \
        / cnt[:, None]
    ref = torch.clamp(pt_ref_kf, min=0).long()
    dist = torch.linalg.vector_norm(pt_pos - centers[ref], dim=-1)
    is_ref = obs_kf == pt_ref_kf[:, None]
    lane = torch.argmax(is_ref.to(torch.int8), dim=-1)
    has_ref = is_ref.any(dim=-1)
    fidx = torch.where(has_ref, obs_idx[torch.arange(B, device=obs_idx.device), lane],
                       torch.zeros_like(lane, dtype=obs_idx.dtype))
    octv = kf_kp_octave[ref, torch.clamp(fidx, min=0).long()]
    level_factor = sf[torch.clamp(octv, 0, n_levels - 1).long()]
    max_d = dist * level_factor
    min_d = max_d / sf[n_levels - 1]
    return normal, min_d, max_d, torch.sum(ok.to(torch.int32), -1) > 0


def update_normal_and_depth_idx(state: MapState, idx: torch.Tensor,
                                idx_ok: torch.Tensor, scale_factors,
                                n_levels: int) -> MapState:
    """`MapPoint::UpdateNormalAndDepth` over the B point slots in `idx`:
    normal = mean unit vector point->camera centre over observations;
    max = dist * scale^octave at the reference KF, min = max / scale^(L-1)."""
    P = state.pt_capacity
    safe = torch.where(idx_ok, idx, torch.full_like(idx, P - 1)).long()
    obs_kf = torch.where(idx_ok[:, None], state.pt_obs_kf[safe],
                         torch.full_like(state.pt_obs_kf[safe], -1))
    normal, min_d, max_d, has = _normal_and_depth_rows(
        state.pt_pos[safe], state.pt_ref_kf[safe], obs_kf,
        state.pt_obs_idx[safe], state.kf_pose, state.kf_kp_octave,
        scale_factors, n_levels)
    upd = idx_ok & has
    return state._replace(
        pt_normal=set_rows(state.pt_normal, idx, normal, upd),
        pt_max_dist=set_rows(state.pt_max_dist, idx, max_d, upd),
        pt_min_dist=set_rows(state.pt_min_dist, idx, min_d, upd),
    )


# ---------------------------------------------------------------------------
# Slot recycling: renumber live slots into a dense prefix (order kept).
# ---------------------------------------------------------------------------


def _valid_first_order(valid: torch.Tensor) -> torch.Tensor:
    return torch.argsort((~valid).to(torch.int8), stable=True)


def compact_points(state: MapState) -> tuple[MapState, torch.Tensor]:
    """Renumber valid points into a dense prefix. Returns (state,
    new_of_old (P,) i32, -1 for dead slots)."""
    valid = state.pt_valid
    i32 = torch.int32
    new_of_old = torch.where(valid, torch.cumsum(valid.to(i32), 0).to(i32) - 1,
                             torch.full_like(state.pt_ref_kf, -1))
    order = _valid_first_order(valid)
    fwd = state.kf_kp_point
    fwd = torch.where(fwd >= 0, new_of_old[torch.clamp(fwd, min=0).long()], fwd)
    v2 = valid[order]
    state = state._replace(
        pt_pos=state.pt_pos[order], pt_valid=v2, pt_desc=state.pt_desc[order],
        pt_normal=state.pt_normal[order], pt_min_dist=state.pt_min_dist[order],
        pt_max_dist=state.pt_max_dist[order],
        pt_ref_kf=torch.where(v2, state.pt_ref_kf[order],
                              torch.full_like(state.pt_ref_kf, -1)),
        pt_first_kf=state.pt_first_kf[order], pt_visible=state.pt_visible[order],
        pt_found=state.pt_found[order], pt_obs_kf=state.pt_obs_kf[order],
        pt_obs_idx=state.pt_obs_idx[order], pt_obs_oct=state.pt_obs_oct[order],
        kf_kp_point=fwd, n_pt=torch.sum(valid.to(i32)).to(i32),
    )
    return state, new_of_old


def compact_keyframes(state: MapState) -> tuple[MapState, torch.Tensor]:
    """Renumber valid keyframes into a dense prefix (slot order kept).
    Returns (state, new_of_old (K,) i32)."""
    valid = state.kf_valid
    i32 = torch.int32
    new_of_old = torch.where(valid, torch.cumsum(valid.to(i32), 0).to(i32) - 1,
                             torch.full_like(state.kf_parent, -1))
    order = _valid_first_order(valid)

    def remap(ids):
        return torch.where(ids >= 0, new_of_old[torch.clamp(ids, min=0).long()], ids)

    v2 = valid[order]
    covis = state.covis[order][:, order]
    covis = torch.where(v2[:, None] & v2[None, :], covis, torch.zeros_like(covis))
    state = state._replace(
        kf_pose=state.kf_pose[order], kf_valid=v2,
        kf_timestamp=state.kf_timestamp[order], kf_frame_id=state.kf_frame_id[order],
        kf_kp_xy=state.kf_kp_xy[order], kf_kp_ur=state.kf_kp_ur[order],
        kf_kp_depth=state.kf_kp_depth[order], kf_kp_octave=state.kf_kp_octave[order],
        kf_kp_angle=state.kf_kp_angle[order], kf_kp_valid=state.kf_kp_valid[order],
        kf_desc=state.kf_desc[order], kf_kp_point=state.kf_kp_point[order],
        covis=covis, kf_parent=remap(state.kf_parent[order]),
        kf_loop_edges=remap(state.kf_loop_edges[order]),
        pt_obs_kf=remap(state.pt_obs_kf), pt_ref_kf=remap(state.pt_ref_kf),
        pt_first_kf=remap(state.pt_first_kf), n_kf=torch.sum(valid.to(i32)).to(i32),
    )
    return state, new_of_old
