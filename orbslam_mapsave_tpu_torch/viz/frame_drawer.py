"""Frame overlay rendering — `FrameDrawer` parity (`src/FrameDrawer.cc`).

Draws the current frame with keypoint/match overlays and a status text bar
(`FrameDrawer::Update` `:169`, `DrawTextInfo` `:131`). Output is a numpy RGB
image (the reference draws into a cv::Mat for Pangolin; we return arrays any
host viewer or notebook can show). Port of
`orbslam_mapsave_tpu/viz/frame_drawer.py`, a numpy copy: the caller hands
it host arrays.
"""

from __future__ import annotations

import numpy as np

STATE_TEXT = {
    0: "WAITING FOR IMAGES",
    1: "TRYING TO INITIALIZE",
    2: "SLAM MODE",
    3: "LOST. TRYING TO RELOCALIZE",
}


def draw_frame(gray: np.ndarray, kp_xy: np.ndarray, kp_valid: np.ndarray,
               matched: np.ndarray | None = None, state: int = 2,
               n_kfs: int = 0, n_points: int = 0) -> np.ndarray:
    """Returns (H+20, W, 3) uint8: frame + overlays + status strip."""
    h, w = gray.shape
    img = np.stack([gray] * 3, -1).astype(np.uint8)
    r = 2
    for i in np.nonzero(np.asarray(kp_valid))[0]:
        x, y = int(kp_xy[i, 0]), int(kp_xy[i, 1])
        if not (r <= x < w - r and r <= y < h - r):
            continue
        is_match = matched is not None and matched[i] >= 0
        color = (0, 255, 0) if is_match else (60, 60, 255)
        # square marker (FrameDrawer draws rectangles+circles)
        img[y - r : y + r + 1, x - r] = color
        img[y - r : y + r + 1, x + r] = color
        img[y - r, x - r : x + r + 1] = color
        img[y + r, x - r : x + r + 1] = color
    # status strip (DrawTextInfo draws onto an extended canvas)
    strip = np.zeros((20, w, 3), np.uint8)
    txt = f"{STATE_TEXT.get(state, '?')} | KFs: {n_kfs} MPs: {n_points}"
    _draw_text(strip, txt)
    return np.concatenate([img, strip], axis=0)


_FONT = {
    c: i for i, c in enumerate(
        "ABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789 .:|?"
    )
}


def _draw_text(canvas: np.ndarray, text: str) -> None:
    """Minimal 5x3 bitmap text (keeps viz dependency-free)."""
    x = 2
    for ch in text.upper():
        if x + 4 >= canvas.shape[1]:
            break
        if ch in _FONT and ch != " ":
            canvas[7:12, x : x + 3] = 220
        x += 4
