"""Hamming descriptor distance as a matrix product + matching primitives.

Port of `orbslam_mapsave_tpu/ops/hamming.py`. For 0/1 bit vectors a, b

    hamming(a,b) = popcount(a) + popcount(b) - 2 * dot(a, b)

so a whole (Na x Nb) distance matrix is one product of bit planes. The
product runs in float32 here (integer matmul has no CUDA path in torch);
every partial sum is an integer <= 256, so it is exact. Thresholds
TH_HIGH=100, TH_LOW=50 (`src/ORBmatcher.cc:37-38`).
"""

from __future__ import annotations

import torch

TH_HIGH = 100
TH_LOW = 50
HISTO_LENGTH = 30

_BIG = 1 << 20  # sentinel distance for excluded entries


def unpack_bits(desc: torch.Tensor) -> torch.Tensor:
    """(...,32) uint8 -> (...,256) int8 bit-planes (LSB-first per byte)."""
    shifts = torch.arange(8, dtype=torch.uint8, device=desc.device)
    bits = (desc[..., :, None] >> shifts) & 1
    return bits.reshape(desc.shape[:-1] + (256,)).to(torch.int8)


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """(N,256) {0,1} -> (N,32) uint8, LSB-first."""
    b = bits.reshape(bits.shape[0], 32, 8).to(torch.int32)
    weights = 1 << torch.arange(8, dtype=torch.int32, device=bits.device)
    return torch.sum(b * weights, dim=-1).to(torch.uint8)


def hamming_matrix_bits(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pairwise Hamming (...,Na,Nb) int32 from pre-unpacked (...,N,256)
    bit-planes (leading dimensions broadcast)."""
    af = a.to(torch.float32)
    bf = b.to(torch.float32)
    pa = torch.sum(a.to(torch.int32), dim=-1)
    pb = torch.sum(b.to(torch.int32), dim=-1)
    dot = (af @ bf.transpose(-1, -2)).to(torch.int32)
    return pa[..., :, None] + pb[..., None, :] - 2 * dot


def hamming_matrix(desc_a: torch.Tensor, desc_b: torch.Tensor) -> torch.Tensor:
    """Full pairwise Hamming distances (Na,Nb) int32 from (N,32) uint8."""
    return hamming_matrix_bits(unpack_bits(desc_a), unpack_bits(desc_b))


def hamming_vec(desc_a: torch.Tensor, desc_b: torch.Tensor) -> torch.Tensor:
    """Elementwise Hamming distance between aligned rows (N,32)x(N,32)->(N,)."""
    x = torch.bitwise_xor(desc_a, desc_b)
    return torch.sum(unpack_bits(x).to(torch.int32), dim=-1)


def masked_best2(dist: torch.Tensor, valid_b: torch.Tensor | None = None,
                 extra_mask: torch.Tensor | None = None):
    """Per-row best and second-best over a distance matrix (...,Na,Nb).

    Returns (best_idx (...,Na) i32, best_dist, second_dist); excluded
    entries get the _BIG sentinel. Ties go to the lowest column, as in
    argmin."""
    d = dist
    big = torch.full_like(d, _BIG)
    if valid_b is not None:
        d = torch.where(valid_b[..., None, :], d, big)
    if extra_mask is not None:
        d = torch.where(extra_mask, d, big)
    best = torch.amin(d, dim=-1)
    idx = torch.argmin(d, dim=-1).to(torch.int32)
    cols = torch.arange(d.shape[-1], dtype=torch.int32, device=d.device)
    second = torch.amin(torch.where(cols == idx[..., None], big, d), dim=-1)
    return idx, best, second


def mutual_best(dist: torch.Tensor, valid_a: torch.Tensor | None,
                valid_b: torch.Tensor | None):
    """Cross-check matching: i<->j kept only if argmin both ways agrees."""
    d = dist
    big = torch.full_like(d, _BIG)
    if valid_a is not None:
        d = torch.where(valid_a[:, None], d, big)
    if valid_b is not None:
        d = torch.where(valid_b[None, :], d, big)
    best_ab = torch.argmin(d, dim=1)
    best_ba = torch.argmin(d, dim=0)
    ok = best_ba[best_ab] == torch.arange(d.shape[0], device=d.device)
    return best_ab, torch.amin(d, dim=1), ok


def rotation_consistency_mask(angles_a: torch.Tensor,
                              angles_b_matched: torch.Tensor,
                              match_ok: torch.Tensor) -> torch.Tensor:
    """Rotation-histogram filter (`src/ORBmatcher.cc:1604-1645`), with the
    reference's `bin = round(rot / HISTO_LENGTH)` quirk: keep matches in the
    top-3 bins, bins 2 and 3 only if they hold >= 0.1 * max. Inputs are
    (...,N); each leading index keeps its own histogram."""
    factor = 1.0 / HISTO_LENGTH
    rot = angles_a - angles_b_matched
    rot = torch.where(rot < 0, rot + 360.0, rot)
    bins = torch.round(rot * factor).to(torch.int32)
    bins = torch.where(bins == HISTO_LENGTH, torch.zeros_like(bins), bins)
    bins = torch.clamp(bins, 0, HISTO_LENGTH - 1)
    counts = torch.zeros(bins.shape[:-1] + (HISTO_LENGTH,), dtype=torch.int32,
                         device=bins.device)
    counts = counts.scatter_add(-1, bins.long(), match_ok.to(torch.int32))
    top3_vals, top3_idx = torch.sort(counts, dim=-1, descending=True, stable=True)
    top3_vals, top3_idx = top3_vals[..., :3], top3_idx[..., :3].to(torch.int32)
    min_count = (0.1 * top3_vals[..., 0].to(torch.float32)).to(torch.int32)
    none = torch.full_like(top3_idx[..., 1], -1)
    keep2 = torch.where(top3_vals[..., 1] >= min_count, top3_idx[..., 1], none)
    keep3 = torch.where(top3_vals[..., 2] >= min_count, top3_idx[..., 2], none)
    in_top = ((bins == top3_idx[..., 0, None]) | (bins == keep2[..., None])
              | (bins == keep3[..., None]))
    return match_ok & in_top
