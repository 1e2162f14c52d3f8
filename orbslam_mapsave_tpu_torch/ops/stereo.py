"""Left-right stereo matching: sub-pixel disparity for every left keypoint.

Port of `orbslam_mapsave_tpu/ops/stereo.py` (`Frame::ComputeStereoMatches`,
`src/Frame.cc:584-756`). The whole (left x right) candidate relation is one
dense mask over the Hamming-distance matrix, and the SAD refinement runs for
every left keypoint at once:

  stage 1  row-band / octave / disparity-range mask (Frame.cc:592-665),
           best Hamming match < TH_HIGH over the masked distance matrix
  stage 2  SAD sliding window, w = 5, L = 5, center-subtracted patches at
           the left keypoint's pyramid level, parabola sub-pixel step
           (Frame.cc:668-721)
  stage 3  accept 0 <= disparity < maxD (= bf / minZ with minZ = baseline,
           i.e. maxD = fx); median-based outlier trim
           thDist = 1.5 * 1.4 * median(SAD) (Frame.cc:742-755)

Deviation kept from the JAX version: the reference's strip-bounds test uses
`iniu = scaleduR0 + L - w` (`Frame.cc:690`), an apparent sign slip that
under-rejects near the left border; the full strip [suR0-L-w, suR0+L+w] is
bounded instead. The SAD sums are integers below 2^24, exact in float32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import hamming, orb

SAD_W = 5  # half window (Frame.cc:678)
SAD_L = 5  # half search range (Frame.cc:685)
_WIN = 2 * SAD_W + 1  # 11
_STRIP = _WIN + 2 * SAD_L  # 21


def stack_pyramid(spec: orb.ORBSpec, image: torch.Tensor) -> torch.Tensor:
    """(L, H0+2E, W0+2E) float32: every padded level zero-extended to the
    level-0 footprint, so per-keypoint patch gathers index one tensor."""
    levels = orb.build_pyramid(spec, image)
    h0, w0 = levels[0].shape
    return torch.stack([F.pad(lv, (0, w0 - lv.shape[1], 0, h0 - lv.shape[0]))
                        for lv in levels])


def _gather_strip(pyr: torch.Tensor, lvl: torch.Tensor, row: torch.Tensor,
                  col: torch.Tensor, width: int) -> torch.Tensor:
    """(N, 11, width) windows of pyramid level `lvl` centered at (row, col)
    (level-local, pre-pad coordinates), one per keypoint. The start indices
    are clamped into [0, dim - size] as `lax.dynamic_slice` clamps them, so
    every gathered index lies inside the tensor."""
    _, Hp, Wp = pyr.shape
    dev = pyr.device
    r0 = torch.clamp(row + orb.EDGE - SAD_W, 0, Hp - _WIN)
    c0 = torch.clamp(col + orb.EDGE - (width - 1) // 2, 0, Wp - width)
    rows = (r0[:, None] + torch.arange(_WIN, device=dev))[:, :, None]
    cols = (c0[:, None] + torch.arange(width, device=dev))[:, None, :]
    return pyr[lvl.long()[:, None, None], rows.long(), cols.long()]


def compute_stereo_matches(spec: orb.ORBSpec, image_left: torch.Tensor,
                           image_right: torch.Tensor, kpl_xy, kpl_octave, kpl_bits,
                           kpl_valid, kpr_xy, kpr_octave, kpr_bits, kpr_valid,
                           bf: float, fx: float):
    """Returns (ur (N,), depth (N,)) for the left keypoints; -1 where there
    is no stereo match (mvuRight / mvDepth init, `Frame.cc:586-587`)."""
    dev = kpl_xy.device
    n_levels = spec.n_levels
    scale_factors = torch.tensor([spec.scale_factor**i for i in range(n_levels)],
                                 dtype=torch.float32, device=dev)
    max_d = fx  # maxD = mbf/minZ, minZ = mb (Frame.cc:612-614)
    min_d = -3.0  # Frame.cc:613
    ul, vl = kpl_xy[:, 0], kpl_xy[:, 1]
    ur_, vr_ = kpr_xy[:, 0], kpr_xy[:, 1]

    # ---- stage 1: masked Hamming best match --------------------------
    r_band = 2.0 * scale_factors[torch.clamp(kpr_octave, min=0).long()]  # Frame.cc:603
    row_ok = torch.abs(vl[:, None] - vr_[None, :]) <= r_band[None, :]
    oct_ok = ((kpr_octave[None, :] >= (kpl_octave - 1)[:, None])
              & (kpr_octave[None, :] <= (kpl_octave + 1)[:, None]))
    u_ok = (ur_[None, :] >= (ul - max_d)[:, None]) & (ur_[None, :] <= (ul - min_d)[:, None])
    mask = row_ok & oct_ok & u_ok & kpl_valid[:, None] & kpr_valid[None, :]
    best_r, best_d, _ = hamming.masked_best2(hamming.hamming_matrix_bits(kpl_bits, kpr_bits),
                                             extra_mask=mask)
    cand = kpl_valid & (best_d < hamming.TH_HIGH)  # Frame.cc:668

    # ---- stage 2: SAD sliding window at the left keypoint's level ----
    pyr_l = stack_pyramid(spec, image_left.to(torch.float32))
    pyr_r = stack_pyramid(spec, image_right.to(torch.float32))
    lvl = torch.clamp(kpl_octave, 0, n_levels - 1).long()
    inv = 1.0 / scale_factors[lvl]
    su_l = torch.round(ul * inv).to(torch.int32)
    sv_l = torch.round(vl * inv).to(torch.int32)
    ur0 = ur_[torch.clamp(best_r, min=0).long()]
    su_r0 = torch.round(ur0 * inv).to(torch.int32)
    lvl_w = torch.tensor([ls.width for ls in spec.levels], dtype=torch.int32, device=dev)[lvl]
    lvl_h = torch.tensor([ls.height for ls in spec.levels], dtype=torch.int32, device=dev)[lvl]
    in_b = ((su_l - SAD_W >= 0) & (su_l + SAD_W < lvl_w)
            & (sv_l - SAD_W >= 0) & (sv_l + SAD_W < lvl_h)
            & (su_r0 - SAD_L - SAD_W >= 0) & (su_r0 + SAD_L + SAD_W < lvl_w))
    cand = cand & in_b

    patch_l = _gather_strip(pyr_l, lvl, sv_l, su_l, _WIN)  # (N,11,11)
    strip_r = _gather_strip(pyr_r, lvl, sv_l, su_r0, _STRIP)  # (N,11,21)
    il = patch_l - patch_l[:, SAD_W, SAD_W][:, None, None]
    # the 11 shifted windows (N,11 rows,11 shifts,11 cols), each
    # center-subtracted (Frame.cc:699-703)
    win = strip_r.unfold(2, _WIN, 1)
    win = win - win[:, SAD_W, :, SAD_W][:, None, :, None]
    sad = torch.sum(torch.abs(il[:, :, None, :] - win), dim=(1, 3))  # (N,11)
    best_inc = torch.argmin(sad, dim=1)  # first minimum; 0..10, center 5
    interior = (best_inc > 0) & (best_inc < 2 * SAD_L)  # Frame.cc:706-707
    i0 = torch.clamp(best_inc, 1, 2 * SAD_L - 1)
    d1, d2, d3 = (torch.gather(sad, 1, (i0 + k)[:, None])[:, 0] for k in (-1, 0, 1))
    denom = 2.0 * (d1 + d3 - 2.0 * d2)
    delta = torch.where(torch.abs(denom) > 1e-9, (d1 - d3) / denom, torch.full_like(denom, 2.0))
    delta_ok = (delta >= -1.0) & (delta <= 1.0)  # Frame.cc:717-718
    best_ur = scale_factors[lvl] * (su_r0.to(torch.float32) + (i0 - SAD_L).to(torch.float32)
                                    + delta)
    disparity = ul - best_ur
    disp_ok = (disparity >= 0) & (disparity < max_d)  # Frame.cc:728
    best_ur = torch.where(disparity <= 0, ul - 0.01, best_ur)  # Frame.cc:730-734
    disparity = torch.clamp(disparity, min=0.01)
    ok = cand & interior & delta_ok & disp_ok

    # ---- stage 3: median SAD trim (Frame.cc:742-755) ------------------
    n_ok = torch.sum(ok.to(torch.int32))
    sorted_sad, _ = torch.sort(torch.where(ok, d2, torch.full_like(d2, float("inf"))))
    median = sorted_sad[torch.clamp(n_ok // 2, 0, d2.shape[0] - 1)]
    ok = ok & (d2 < 1.5 * 1.4 * median)
    none = torch.full_like(best_ur, -1.0)
    return torch.where(ok, best_ur, none), torch.where(ok, bf / disparity, none)
