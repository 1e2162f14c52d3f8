"""Map rendering — `MapDrawer` parity (`src/MapDrawer.cc`).

The reference draws GL points/keyframes/covisibility graph/camera frustum
into Pangolin (`DrawMapPoints` `:43`, `DrawKeyFrames` `:117`,
`DrawCurrentCamera` `:212`). Here the same content renders to a matplotlib
figure (offline / notebook friendly, no GL dependency). Port of
`orbslam_mapsave_tpu/viz/map_drawer.py`: the map's fields come to the host
in one copy (`host_fields`), then numpy and matplotlib as there.
"""

from __future__ import annotations

import numpy as np
import torch

from ..slammap import mapstate as ms


def host_fields(state: ms.MapState, names: tuple[str, ...]) -> dict[str, np.ndarray]:
    """The named fields of a map as numpy arrays of their own dtypes, in one
    device-to-host copy (one sync) whatever the map's device. Every field
    is bool, int32 or float32, exact in float64."""
    ts = [getattr(state, n) for n in names]
    flat = torch.cat([t.reshape(-1).to(torch.float64) for t in ts]).cpu().numpy()
    out, i = {}, 0
    for n, t in zip(names, ts):
        dtype = torch.empty(0, dtype=t.dtype).numpy().dtype
        out[n] = flat[i:i + t.numel()].reshape(tuple(t.shape)).astype(dtype)
        i += t.numel()
    return out


def plot_map(state: ms.MapState, ax=None, draw_graph: bool = True,
             current_pose_cw: np.ndarray | None = None):
    """Top-down (x-z) map view; returns the matplotlib axis."""
    import matplotlib

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    if ax is None:
        _, ax = plt.subplots(figsize=(6, 6))
    h = host_fields(state, ("pt_pos", "pt_valid", "kf_pose", "kf_valid", "covis"))
    pts = h["pt_pos"]
    ptv = h["pt_valid"]
    ax.scatter(pts[ptv, 0], pts[ptv, 2], s=1, c="k", alpha=0.4,
               label="map points")
    kfp = h["kf_pose"]
    kfv = h["kf_valid"]
    centers = []
    for k in np.nonzero(kfv)[0]:
        T = kfp[k]
        R, t = T[:3, :3], T[:3, 3]
        c = -R.T @ t
        centers.append((k, c))
    if centers:
        arr = np.stack([c for _, c in centers])
        ax.plot(arr[:, 0], arr[:, 2], "b.-", ms=4, lw=0.8, label="keyframes")
    if draw_graph and centers:
        covis = h["covis"]
        idx = {k: c for k, c in centers}
        for k, c in centers:
            for j in np.nonzero(covis[k] >= ms.COVIS_MIN_WEIGHT)[0]:
                if j > k and j in idx:
                    ax.plot([c[0], idx[j][0]], [c[2], idx[j][2]], "g-",
                            lw=0.3, alpha=0.5)
    if current_pose_cw is not None:
        R, t = current_pose_cw[:3, :3], current_pose_cw[:3, 3]
        c = -R.T @ t
        ax.plot([c[0]], [c[2]], "r^", ms=10, label="camera")
    ax.set_xlabel("x [m]")
    ax.set_ylabel("z [m]")
    ax.set_aspect("equal")
    ax.legend(loc="upper right", fontsize=7)
    return ax


def save_map_png(state: ms.MapState, path: str,
                 current_pose_cw: np.ndarray | None = None) -> None:
    import matplotlib.pyplot as plt

    ax = plot_map(state, current_pose_cw=current_pose_cw)
    ax.figure.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(ax.figure)
