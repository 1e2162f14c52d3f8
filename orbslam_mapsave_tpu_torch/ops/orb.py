"""Batched ORB pyramid feature extraction on torch tensors.

Port of `orbslam_mapsave_tpu/ops/orb.py` (the `ORBextractor` replacement,
`src/ORBextractor.cc:1042-1108`): whole-image stages with static shapes.

- pyramid: separable linear resize as two matrix products, rounded to
  integers (the reference writes an 8U level), inside a reflect-101 border;
- FAST-9/16 score map for every pixel, 3x3 non-max suppression, the
  per-cell dual threshold and per-cell top-k, then a per-level top-N;
- intensity-centroid angle over the radius-15 circular patch;
- rotated BRIEF-256 on the rounded 7x7 sigma-2 blur.

Parity notes (the JAX version is the reference):
- the resize matrices are what `jax.image.resize(eye, ..., "linear")`
  builds: a triangle kernel widened by the scale when downsampling
  (antialiasing), half-pixel centres and normalised weights, rebuilt here in
  float32 numpy (`resize_matrix`). `F.interpolate` gives other pixels;
- `lax.top_k` puts the lower index first among equal values; here every
  top-k is a stable descending sort, which does the same;
- the FAST score and the BRIEF row select run in float32 here; the JAX
  version runs them in bf16, which is exact for the integer pixels both
  versions see.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from ..utils import cudagraph, metrics, staging
from .orb_pattern import BIT_PATTERN_31

HALF_PATCH = 15  # ORBextractor.cc:73
PATCH_SIZE = 31
EDGE = 19  # EDGE_THRESHOLD, ORBextractor.cc:72 — also the pyramid pad width
DESC_PAD = 21  # max |rounded rotated BRIEF offset| (pattern radius ~17.7)
PATCH49 = 2 * (DESC_PAD + 3) + 1  # 49: BRIEF window (43) + blur margin (3)

# FAST 16-pixel Bresenham circle, radius 3, circular order (dy, dx)
_FAST_RING = np.array(
    [
        (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
        (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
    ],
    dtype=np.int32,
)


def compute_umax() -> np.ndarray:
    """Circular-patch row extents, exactly the reference ctor's algorithm
    (`src/ORBextractor.cc:452-468`)."""
    hp = HALF_PATCH
    umax = np.zeros(hp + 2, dtype=np.int64)
    vmax = int(np.floor(hp * np.sqrt(2.0) / 2 + 1))
    vmin = int(np.ceil(hp * np.sqrt(2.0) / 2))
    hp2 = hp * hp
    for v in range(vmax + 1):
        umax[v] = int(round(np.sqrt(hp2 - v * v)))
    v0 = 0
    for v in range(hp, vmin - 1, -1):
        while umax[v0] == umax[v0 + 1]:
            v0 += 1
        umax[v] = v0
        v0 += 1
    return umax[: hp + 1]


_UMAX = compute_umax()


def _circular_mask() -> np.ndarray:
    """(31,31) boolean mask of the IC_Angle patch from _UMAX."""
    mask = np.zeros((PATCH_SIZE, PATCH_SIZE), dtype=bool)
    for v in range(-HALF_PATCH, HALF_PATCH + 1):
        u_extent = _UMAX[abs(v)]
        mask[v + HALF_PATCH, HALF_PATCH - u_extent: HALF_PATCH + u_extent + 1] = True
    return mask


_IC_MASK = _circular_mask()
# (31,31) circular-mask moment weights for the patch-form IC angle
_IC_DU = ((np.arange(PATCH_SIZE) - HALF_PATCH)[None, :] * _IC_MASK).astype(np.float32)
_IC_DV = ((np.arange(PATCH_SIZE) - HALF_PATCH)[:, None] * _IC_MASK).astype(np.float32)


def _gaussian_kernel_7x7(sigma: float = 2.0) -> np.ndarray:
    """7-tap Gaussian (cv::GaussianBlur(7,7,2,2) parity)."""
    r = np.arange(7) - 3
    k = np.exp(-(r**2) / (2.0 * sigma * sigma))
    k /= k.sum()
    return k.astype(np.float32)


_BLUR_K = [float(v) for v in _gaussian_kernel_7x7()]


@dataclasses.dataclass(frozen=True)
class LevelSpec:
    height: int
    width: int
    scale: float
    budget: int  # mnFeaturesPerLevel[level]
    cell: int  # selection cell size
    k_per_cell: int
    n_cells_y: int
    n_cells_x: int
    cand_cap: int  # = n_cells * k_per_cell


@dataclasses.dataclass(frozen=True)
class ORBSpec:
    """Static extraction plan for one image geometry."""

    height: int
    width: int
    n_features: int
    n_levels: int
    scale_factor: float
    ini_th: int
    min_th: int
    max_kp: int
    levels: tuple[LevelSpec, ...]

    @staticmethod
    def create(height: int, width: int, n_features: int = 2000,
               n_levels: int = 4, scale_factor: float = 1.5,
               ini_th: int = 15, min_th: int = 3, max_kp: int = 2048,
               cell: int = 16) -> "ORBSpec":
        # per-level budgets: geometric split, remainder to the top level
        # (`src/ORBextractor.cc:434-445`)
        factor = 1.0 / scale_factor
        n_desired = n_features * (1 - factor) / (1 - factor**n_levels)
        budgets = []
        total = 0
        for _ in range(n_levels - 1):
            b = int(round(n_desired))
            budgets.append(b)
            total += b
            n_desired *= factor
        budgets.append(max(n_features - total, 0))

        levels = []
        h, w = height, width
        for lvl in range(n_levels):
            scale = scale_factor**lvl
            if lvl > 0:
                h = int(round(height / scale))
                w = int(round(width / scale))
            ncy = max(1, h // cell)
            ncx = max(1, w // cell)
            n_cells = ncy * ncx
            k = max(6, math.ceil(4.0 * budgets[lvl] / n_cells))
            k = min(k, cell * cell)
            levels.append(
                LevelSpec(h, w, scale, budgets[lvl], cell, k, ncy, ncx, n_cells * k)
            )
        return ORBSpec(height, width, n_features, n_levels, scale_factor,
                       ini_th, min_th, max_kp, tuple(levels))


def topk_stable(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """`lax.top_k` semantics along the last dim: the k largest values,
    lower index first among equal values."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


@functools.lru_cache(maxsize=None)
def resize_matrix(in_size: int, out_size: int) -> np.ndarray:
    """(out, in) float32 matrix of `jax.image.resize(eye(in), (out, in),
    method="linear")`: antialiased triangle kernel (widened by 1/scale when
    downsampling), half-pixel centres, weights normalised per output."""
    f32 = np.float32
    inv_scale = f32(1.0 / (out_size / in_size))
    kernel_scale = max(inv_scale, f32(1.0))
    sample_f = ((np.arange(out_size, dtype=f32) + f32(0.5)) * inv_scale
                - f32(0.0) * inv_scale - f32(0.5))
    # XLA folds the division by the constant kernel scale into a product
    # with its float32 reciprocal; so does this
    x = np.abs(sample_f[None, :] - np.arange(in_size, dtype=f32)[:, None]) \
        * (f32(1.0) / kernel_scale)
    weights = np.maximum(f32(0.0), f32(1.0) - np.abs(x)).astype(f32)
    total = np.zeros((1, out_size), f32)
    for i in range(in_size):  # sequential sum, like XLA's reduction
        total = total + weights[i:i + 1]
    weights = np.where(np.abs(total) > f32(1000.0 * np.finfo(np.float32).eps),
                       weights / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample_f >= -0.5) & (sample_f <= f32(in_size - 0.5))
    return np.where(inside[None, :], weights, f32(0.0)).T.astype(f32)


@functools.lru_cache(maxsize=None)
def resize_matrix_on(in_size: int, out_size: int, device: torch.device) -> torch.Tensor:
    """`resize_matrix` on `device`, copied there once."""
    return torch.from_numpy(resize_matrix(in_size, out_size)).to(device)


@functools.lru_cache(maxsize=None)
def nearest_index(in_size: int, out_size: int) -> np.ndarray:
    """(out,) int64 source rows of `jax.image.resize(..., method="nearest")`:
    floor((i + 0.5) * in / out) at half-pixel centres, with the float32
    rounding XLA gives it. XLA folds `* in / out` into one product with the
    constant f32(in) * f32(1 / out); `F.interpolate`'s "nearest" (no half
    pixel) and "nearest-exact" (another rounding of the ratio) pick other
    rows at the pyramid's level sizes."""
    f32 = np.float32
    ratio = f32(in_size) * (f32(1.0) / f32(out_size))
    return np.floor((np.arange(out_size, dtype=f32) + f32(0.5)) * ratio).astype(np.int64)


@functools.lru_cache(maxsize=None)
def nearest_index_on(in_size: int, out_size: int, device: torch.device) -> torch.Tensor:
    """`nearest_index` on `device`, copied there once."""
    return torch.from_numpy(nearest_index(in_size, out_size)).to(device)


class AngleBriefTables(NamedTuple):
    ic_du: torch.Tensor  # (31,31) f32 column-moment weights of the circular patch
    ic_dv: torch.Tensor  # (31,31) f32 row-moment weights
    px: torch.Tensor  # (512,) f32 BRIEF x offsets: the pattern's first points, then its second
    py: torch.Tensor  # (512,) f32 BRIEF y offsets
    bit_weights: torch.Tensor  # (8,) i32 1, 2, ..., 128: bits packed LSB-first


@functools.lru_cache(maxsize=None)
def angle_brief_tables(device: torch.device) -> AngleBriefTables:
    """The IC moments, the BRIEF pattern and the bit weights on `device`,
    copied there once."""
    pat = np.asarray(BIT_PATTERN_31, np.float32)
    return AngleBriefTables(
        *(torch.from_numpy(a).to(device) for a in (
            _IC_DU, _IC_DV, np.concatenate([pat[:, 0], pat[:, 2]]),
            np.concatenate([pat[:, 1], pat[:, 3]]),
            np.array([1, 2, 4, 8, 16, 32, 64, 128], np.int32))))


def resize_mask_nearest(mask: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """The (H,W) mask sampled at a level's (height, width) as
    `jax.image.resize(mask, ..., method="nearest")` samples it."""
    h, w = mask.shape
    if (h, w) == (height, width):
        return mask
    ys = nearest_index_on(h, height, mask.device)
    xs = nearest_index_on(w, width, mask.device)
    return mask[ys[:, None], xs[None, :]]


def reflect101_pad(img: torch.Tensor, pad: int) -> torch.Tensor:
    """cv::BORDER_REFLECT_101 padding (edge pixel not duplicated)."""
    return F.pad(img[None, None], (pad, pad, pad, pad), mode="reflect")[0, 0]


def build_pyramid(spec: ORBSpec, image: torch.Tensor) -> list[torch.Tensor]:
    """List of EDGE-padded level images (Hl+2E, Wl+2E) float32
    (`ComputePyramid`, `src/ORBextractor.cc:1110-1135`)."""
    levels = []
    cur = image.to(torch.float32)
    prev_h, prev_w = spec.height, spec.width
    for lvl, ls in enumerate(spec.levels):
        if lvl > 0:
            R_h = resize_matrix_on(prev_h, ls.height, cur.device)
            R_w = resize_matrix_on(prev_w, ls.width, cur.device)
            cur = torch.round(R_h @ cur @ R_w.T)
        levels.append(reflect101_pad(cur, EDGE))
        prev_h, prev_w = ls.height, ls.width
    return levels


def fast_score_map(img: torch.Tensor, th_for_corner: int) -> torch.Tensor:
    """FAST-9/16 score for every pixel of `img` (H,W): the max threshold at
    which the segment test still passes, plus a sub-integer tie-breaker
    (mean |ring contrast|); 0 where not a corner or within 3 px of the
    border."""
    h, w = img.shape
    pad = F.pad(img[None, None], (3, 3, 3, 3), mode="replicate")[0, 0]
    ring = torch.stack(
        [pad[3 + dy: 3 + dy + h, 3 + dx: 3 + dx + w] for dy, dx in _FAST_RING]
    )  # (16,H,W)
    d = ring - img[None]  # integers in [-255,255]: exact in f32

    def arc9_min(x):
        # min over all 9-long circular windows, via doubling rolls on dim 0
        r2 = torch.minimum(x, torch.roll(x, -1, dims=0))
        r4 = torch.minimum(r2, torch.roll(r2, -2, dims=0))
        r8 = torch.minimum(r4, torch.roll(r4, -4, dims=0))
        r9 = torch.minimum(r8, torch.roll(x, -8, dims=0))
        return torch.amax(r9, dim=0)

    score = torch.maximum(arc9_min(d), arc9_min(-d))
    # integer sum of 16 terms <= 4080: exact in any order
    tie = torch.sum(torch.abs(d), dim=0) * (0.99 / 4096.0)
    score = torch.where(score > th_for_corner, score + tie, torch.zeros_like(score))
    ys = torch.arange(h, device=img.device)[:, None]
    xs = torch.arange(w, device=img.device)[None, :]
    inb = (ys >= 3) & (ys < h - 3) & (xs >= 3) & (xs < w - 3)
    return torch.where(inb, score, torch.zeros_like(score))


def _nms3(score: torch.Tensor) -> torch.Tensor:
    """3x3 non-max suppression (-inf padded window max)."""
    neigh = F.max_pool2d(score[None, None], kernel_size=3, stride=1,
                         padding=1)[0, 0]
    return torch.where((score >= neigh) & (score > 0), score,
                       torch.zeros_like(score))


def detect_level(spec: ORBSpec, ls: LevelSpec, padded: torch.Tensor):
    """FAST + dual-threshold cells + per-cell top-k on one level.

    Returns (xy (C,2) int32 level coords, score (C,) f32), invalid entries
    scored 0. C = ls.cand_cap."""
    dev = padded.device
    with metrics.span("orb.fast_nms"):
        img = padded[EDGE: EDGE + ls.height, EDGE: EDGE + ls.width]
        score_min = _nms3(fast_score_map(img, spec.min_th))
        b = EDGE - 3  # minBorder (src/ORBextractor.cc:770-775)
        ys = torch.arange(ls.height, device=dev)[:, None]
        xs = torch.arange(ls.width, device=dev)[None, :]
        inb = (ys >= b) & (ys < ls.height - b) & (xs >= b) & (xs < ls.width - b)
        score_min = torch.where(inb, score_min, torch.zeros_like(score_min))

    with metrics.span("orb.topk"):
        # dual threshold per cell (src/ORBextractor.cc:808-815)
        cy, cx, cell = ls.n_cells_y, ls.n_cells_x, ls.cell
        crop = score_min[: cy * cell, : cx * cell]
        cells = crop.reshape(cy, cell, cx, cell).permute(0, 2, 1, 3)
        has_ini = torch.amax(cells, dim=(2, 3)) > spec.ini_th
        keep = torch.where(has_ini[:, :, None, None], cells > spec.ini_th, cells > 0.0)
        cells = torch.where(keep, cells, torch.zeros_like(cells))

        topv, topi = topk_stable(cells.reshape(cy * cx, cell * cell), ls.k_per_cell)
        cell_ids = torch.arange(cy * cx, device=dev)
        yy = (cell_ids // cx)[:, None] * cell + topi // cell
        xx = (cell_ids % cx)[:, None] * cell + topi % cell
        xy = torch.stack([xx.reshape(-1), yy.reshape(-1)], dim=-1).to(torch.int32)
        return xy, topv.reshape(-1)


def gaussian_blur7(padded: torch.Tensor) -> torch.Tensor:
    """Separable 7x7 sigma-2 Gaussian as weighted shift-adds with wrapping
    rolls (the wrapped band lies inside the EDGE padding), summed in the
    JAX version's order."""
    k = _BLUR_K

    def pass1d(img, dim):
        out = k[3] * img
        for d in (1, 2, 3):
            out = out + k[3 - d] * torch.roll(img, d, dims=dim) \
                + k[3 + d] * torch.roll(img, -d, dims=dim)
        return out

    return pass1d(pass1d(padded, 0), 1)


def cut_patches_2ch(stack: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """(B,2,49,49) patches from an integer-valued (2,Hp,Wp) stack around
    level-coord keypoints xy (B,2): a direct gather, exact like the JAX
    version's bf16 one-hot contraction. Indices are clamped to the level,
    which only touches unselected (score 0) candidates."""
    r = DESC_PAD + 3
    _, Hp, Wp = stack.shape
    ar = torch.arange(PATCH49, device=stack.device)
    ys = (xy[:, 1:2].long() + (EDGE - r) + ar[None, :]).clamp(0, Hp - 1)
    xs = (xy[:, 0:1].long() + (EDGE - r) + ar[None, :]).clamp(0, Wp - 1)
    p = stack[:, ys[:, :, None], xs[:, None, :]]  # (2,B,49,49)
    return p.permute(1, 0, 2, 3)


def ic_angles_from_patches(patches49: torch.Tensor) -> torch.Tensor:
    """IC angle in degrees from the (31,31) interior of the 49x49 patches
    (`IC_Angle`, `src/ORBextractor.cc:76-103`). The moments are integer
    sums below 2^24, exact in f32 in any order."""
    r = DESC_PAD + 3 - HALF_PATCH  # 9
    inner = patches49[:, r:r + PATCH_SIZE, r:r + PATCH_SIZE]
    t = angle_brief_tables(inner.device)
    m10 = torch.sum(inner * t.ic_du, dim=(1, 2))
    m01 = torch.sum(inner * t.ic_dv, dim=(1, 2))
    ang = torch.atan2(m01, m10) * (180.0 / math.pi)
    return torch.where(ang < 0, ang + 360.0, ang)


def brief_from_patches(patches43: torch.Tensor, angles_deg: torch.Tensor
                       ) -> torch.Tensor:
    """Rotated BRIEF-256 from blurred, rounded 43x43 patches, (C,32) u8
    (`computeOrbDescriptor`, `src/ORBextractor.cc:107-146`): sample at
    (row=round(px*sin+py*cos), col=round(px*cos-py*sin)), bit = I(p0) <
    I(p1), bits packed LSB-first."""
    c = patches43.shape[0]
    dev = patches43.device
    rad = angles_deg * (math.pi / 180.0)
    a = torch.cos(rad)
    b = torch.sin(rad)
    t = angle_brief_tables(dev)
    px, py = t.px, t.py
    col_off = torch.round(px[None, :] * a[:, None] - py[None, :] * b[:, None]).long()
    row_off = torch.round(px[None, :] * b[:, None] + py[None, :] * a[:, None]).long()
    p_int = torch.round(patches43)
    ci = torch.arange(c, device=dev)[:, None]
    vals = p_int[ci, row_off + DESC_PAD, col_off + DESC_PAD]  # (C,512)
    bits = (vals[:, :256] < vals[:, 256:]).to(torch.int32)
    return torch.sum(bits.reshape(c, 32, 8) * t.bit_weights, dim=-1).to(torch.uint8)


def extract(spec: ORBSpec, image, mask=None) -> dict:
    """Full ORB extraction on one grayscale image (H,W) in [0,255], a tensor
    of any numeric dtype, by the `Extractor` kept for (spec, the image's
    device): on a CUDA tensor one graph replay.

    `mask` (H,W): zero/False pixels are excluded, the fork's human-mask
    hook (`src/ORBextractor.cc:1048-1053`, `src/Tracking.cc:373-384`). As in
    the JAX version, a candidate whose centre falls in the masked region
    (the mask sampled nearest at its level) scores 0 before the level's
    top-k, so the level's budget refills from unmasked corners.

    Returns a fixed-capacity keypoint dict: xy (M,2) f32 level-0 pixel
    coords, response (M,), angle_deg (M,), octave (M,) i32, size (M,),
    desc (M,32) u8, valid (M,) bool — M = spec.max_kp."""
    return _extractor(spec, torch.as_tensor(image).device)(image, mask)


@functools.lru_cache(maxsize=None)
def _extractor(spec: ORBSpec, device: torch.device) -> "Extractor":
    return Extractor(spec, device)


class Extractor:
    """ORB extraction (`extract`) for one `ORBSpec` on one device.

    A call stages the image (and mask) into the static inputs kept for its
    input kind (the image's dtype, whether a mask is given), runs the eager
    body `_extract` over them as one `cudagraph.Graph` and clones the
    outputs, so a result stays valid after later calls. On a CUDA device
    that is one graph replay of ~1,000 small launches; the warm-up before
    the capture puts the constant tables on the device. A host image and
    mask reach the static inputs through pinned staging buffers
    (`utils/staging.py`), a device one by a device-to-device copy; the
    image is converted to float32 inside the body.
    """

    def __init__(self, spec: ORBSpec, device):
        self.spec = spec
        self.device = torch.device(device)
        self._graphs: dict[tuple, _Graph] = {}  # (image dtype, masked) -> graph
        self._staging = staging.Staging(self.device)

    @metrics.traced("orb.extract")
    def __call__(self, image, mask=None) -> dict:
        spec = self.spec
        image = torch.as_tensor(image)
        if tuple(image.shape) != (spec.height, spec.width):
            raise ValueError(
                f"image shape {tuple(image.shape)} != ORBSpec ({spec.height}, "
                f"{spec.width}) — Camera.width/height in the settings yaml must "
                "match the input")
        key = (image.dtype, mask is not None)
        graph = self._graphs.get(key)
        if graph is None:
            graph = self._graphs[key] = _Graph(spec, self.device, *key)
        self._staging("image", image, out=graph.image)
        if mask is not None:
            self._staging("mask", mask, out=graph.mask)
        return {k: v.clone() for k, v in graph.run().items()}


class _Graph:
    """One extraction's static inputs and its `cudagraph.Graph`."""

    def __init__(self, spec: ORBSpec, device: torch.device, dtype: torch.dtype,
                 masked: bool):
        shape = (spec.height, spec.width)
        self.image = torch.empty(shape, dtype=dtype, device=device)
        self.mask = torch.empty(shape, dtype=torch.float32, device=device) if masked else None
        self.run = cudagraph.Graph(
            "orb.graph", self.image.device,
            lambda: _extract(spec, self.image.to(torch.float32), self.mask))


def _extract(spec: ORBSpec, image: torch.Tensor, mask: torch.Tensor | None) -> dict:
    """`extract`'s eager body on a float32 image and mask on one device."""
    dev = image.device
    with metrics.span("orb.pyramid"):
        pyramid = build_pyramid(spec, image)
    all_xy, all_resp, all_ang, all_oct, all_desc = [], [], [], [], []
    W43 = 2 * DESC_PAD + 1
    for lvl, ls in enumerate(spec.levels):
        padded = pyramid[lvl]
        xy, score = detect_level(spec, ls, padded)
        with metrics.span("orb.topk"):
            if mask is not None:
                m = resize_mask_nearest(mask, ls.height, ls.width)
                xyl = xy.long()
                score = torch.where(m[xyl[:, 1], xyl[:, 0]] > 0, score, torch.zeros_like(score))
            score_sel, sel = topk_stable(score, min(ls.budget, score.shape[0]))
            xy = xy[sel]
        with metrics.span("orb.patches"):
            blurred = torch.round(gaussian_blur7(padded))
            pp = cut_patches_2ch(torch.stack([padded, blurred]), xy)
        with metrics.span("orb.angle_brief"):
            ang = ic_angles_from_patches(pp[:, 0])
            desc = brief_from_patches(pp[:, 1, 3:3 + W43, 3:3 + W43], ang)
        all_xy.append(xy.to(torch.float32) * ls.scale)
        all_resp.append(torch.where(score_sel > 0, score_sel,
                                    torch.full_like(score_sel, -math.inf)))
        all_ang.append(ang)
        all_oct.append(torch.full((xy.shape[0],), lvl, dtype=torch.int32,
                                  device=dev))
        all_desc.append(desc)

    xy = torch.cat(all_xy)
    resp = torch.cat(all_resp)
    ang = torch.cat(all_ang)
    octv = torch.cat(all_oct)
    desc = torch.cat(all_desc)
    m = xy.shape[0]
    cap = spec.max_kp
    if m < cap:
        pad = cap - m
        xy = torch.cat([xy, xy.new_zeros((pad, 2))])
        resp = torch.cat([resp, resp.new_full((pad,), -math.inf)])
        ang = torch.cat([ang, ang.new_zeros((pad,))])
        octv = torch.cat([octv, octv.new_zeros((pad,))])
        desc = torch.cat([desc, desc.new_zeros((pad, 32))])
    elif m > cap:
        resp, sel = topk_stable(resp, cap)
        xy, ang, octv, desc = xy[sel], ang[sel], octv[sel], desc[sel]
    valid = torch.isfinite(resp)
    size = PATCH_SIZE * (spec.scale_factor ** octv.to(torch.float32))
    return dict(
        xy=xy, response=torch.where(valid, resp, torch.zeros_like(resp)),
        angle_deg=ang, octave=octv, size=size, desc=desc, valid=valid,
    )
