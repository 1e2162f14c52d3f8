"""The traffic generator: a seeded episode in a textured box room.

A frozen copy of the port's synthetic scene (`BoxRoom`, `circle_trajectory`
of `io/synthetic.py`), so that a later change to the program cannot move the
yardstick. Two things are added: the circle's start angle, which is all
that `--seed` sets, and the splice of a traffic file (stretches of the
trajectory in order, so that the camera may be carried back). A traffic
that lists its `starts` (degrees) plays an episode from each of them for
every seed, in an order the seed draws, so that every seed does the same
work; one without plays one episode from an angle the seed draws.

`BoxRoom.render` is the plain NumPy renderer; `render_frames` renders the
same rays in torch (float64) on the run's device, in a few large calls, and
is held to it by the tests.
"""

from __future__ import annotations

import hashlib
import math
from pathlib import Path

import numpy as np

T0 = 1000.0  # timestamp of an episode's first frame; frames are 1/fps apart
SEED_STREAM = 0x5EED  # mixes `--seed` into the start angle's generator


def _smooth_noise_texture(rng: np.random.Generator, size: int, octaves: int = 4) -> np.ndarray:
    """Band-limited value noise in [0, 255] with a contrast stretch, as the
    port's `io/synthetic._smooth_noise_texture`: smooth broadband noise so
    that window searches do not lock one cell over, a finest octave of a
    few pixels so that descriptors survive resampling, and a stretch so
    that BRIEF pairs differ by more than a gray level."""
    tex = np.zeros((size, size), np.float32)
    amp = 1.0
    for o in range(octaves):
        n = min(size // 4, max(2, 32 << o))
        coarse = rng.uniform(0, 1, (n, n)).astype(np.float32)
        yi = np.linspace(0, n - 1, size)
        xi = np.linspace(0, n - 1, size)
        y0 = np.clip(yi.astype(int), 0, n - 2)
        x0 = np.clip(xi.astype(int), 0, n - 2)
        fy = (yi - y0)[:, None]
        fx = (xi - x0)[None, :]
        up = (coarse[np.ix_(y0, x0)] * (1 - fy) * (1 - fx)
              + coarse[np.ix_(y0 + 1, x0)] * fy * (1 - fx)
              + coarse[np.ix_(y0, x0 + 1)] * (1 - fy) * fx
              + coarse[np.ix_(y0 + 1, x0 + 1)] * fy * fx)
        tex += amp * up
        amp *= 0.55
    tex -= tex.min()
    tex /= tex.max()
    tex = 0.5 + 0.5 * np.tanh(4.0 * (tex - np.median(tex)))
    tex -= tex.min()
    tex /= tex.max()
    return (tex * 255.0).astype(np.float32)


# (axis, sign) of the six faces; a face is the plane x_axis = sign * h
FACES = [(0, 1), (0, -1), (1, 1), (1, -1), (2, 1), (2, -1)]


class BoxRoom:
    """Axis-aligned cube [-h, h]^3 with a texture on each inner face."""

    def __init__(self, half_size: float = 2.0, tex_size: int = 1024, seed: int = 0,
                 cache_dir: Path | None = None):
        self.h = float(half_size)
        self.tex_size = tex_size
        path = (cache_dir / f"room_{half_size}_{tex_size}_{seed}.npy"
                if cache_dir is not None else None)
        if path is not None and path.exists():
            self.textures = list(np.load(path))
            return
        rng = np.random.default_rng(seed)
        self.textures = [_smooth_noise_texture(rng, tex_size) for _ in range(6)]
        if path is not None:
            path.parent.mkdir(parents=True, exist_ok=True)
            tmp = path.with_name(path.name + ".part.npy")
            np.save(tmp, np.stack(self.textures))
            tmp.replace(path)

    def render(self, K: np.ndarray, Twc: np.ndarray, width: int, height: int
               ) -> tuple[np.ndarray, np.ndarray]:
        """(gray (H,W) float32 in [0, 255], z-depth (H,W) float32 meters) of
        one camera pose, by casting each pixel's ray to the nearest face."""
        fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
        u, v = np.meshgrid(np.arange(width, dtype=np.float64),
                           np.arange(height, dtype=np.float64))
        dirs_cam = np.stack([(u - cx) / fx, (v - cy) / fy, np.ones_like(u)], axis=-1)
        R, o = Twc[:3, :3], Twc[:3, 3]
        dirs = dirs_cam @ R.T
        h, n = self.h, self.tex_size
        best_t = np.full((height, width), np.inf)
        gray = np.zeros((height, width), np.float32)
        for face, (axis, sign) in enumerate(FACES):
            d = dirs[..., axis]
            with np.errstate(divide="ignore", invalid="ignore"):
                t = (sign * h - o[axis]) / d
            hit = (t > 1e-6) & np.isfinite(t)
            t = np.where(hit, t, 1.0)
            p = o[None, None, :] + t[..., None] * dirs
            other = [a for a in range(3) if a != axis]
            inside = (np.abs(p[..., other[0]]) <= h) & (np.abs(p[..., other[1]]) <= h)
            valid = hit & inside & (t < best_t)
            if not valid.any():
                continue
            a = np.clip((p[..., other[0]] / (2 * h) + 0.5) * (n - 1), 0, n - 1.001)
            b = np.clip((p[..., other[1]] / (2 * h) + 0.5) * (n - 1), 0, n - 1.001)
            a0, b0 = a.astype(int), b.astype(int)
            fa, fb = a - a0, b - b0
            a1, b1 = np.minimum(a0 + 1, n - 1), np.minimum(b0 + 1, n - 1)
            tex = self.textures[face]
            val = (tex[b0, a0] * (1 - fa) * (1 - fb) + tex[b0, a1] * fa * (1 - fb)
                   + tex[b1, a0] * (1 - fa) * fb + tex[b1, a1] * fa * fb)
            gray = np.where(valid, val.astype(np.float32), gray)
            best_t = np.where(valid, t, best_t)
        depth = (best_t * dirs_cam[..., 2]).astype(np.float32)
        depth[~np.isfinite(depth)] = 0.0
        return gray, depth


def circle_trajectory(n_frames: int, radius: float = 0.55, revs: float = 1.05,
                      height_bob: float = 0.05, start: float = 0.0) -> np.ndarray:
    """(N,4,4) camera-to-world poses on a circle, looking radially outward,
    over `revs` revolutions from the angle `start` (radians): after a full
    turn the camera sees its first views again, which closes a loop."""
    poses = np.zeros((n_frames, 4, 4))
    for i in range(n_frames):
        th = start + 2 * np.pi * revs * i / n_frames
        c, s = np.cos(th), np.sin(th)
        T = np.eye(4)
        T[:3, :3] = [[c, 0, s], [0, 1, 0], [-s, 0, c]]
        T[:3, 3] = [radius * s, height_bob * np.sin(4 * th), radius * c]
        poses[i] = T
    return poses


def _draw(seed: int, stream: str) -> int:
    """64 bits drawn from `seed`: any whole number is taken, however
    large, since it is hashed, not cast."""
    digest = hashlib.sha256(f"{SEED_STREAM}:{stream}{int(seed)}".encode()).digest()
    return int.from_bytes(digest[:8], "little")


def start_angle(seed: int) -> float:
    """A start angle drawn from `seed`, uniform in [0, 2 pi)."""
    return 2 * math.pi * (_draw(seed, "") / 2.0**64)


def start_angles(traffic: dict, seed: int) -> list:
    """The start angle (radians) of each of `seed`'s episodes: the
    traffic's `starts`, all of them in an order the seed draws, or one
    angle drawn from the seed where it lists none."""
    if "starts" not in traffic:
        return [start_angle(seed)]
    perm = np.random.default_rng(_draw(seed, "order:")).permutation(len(traffic["starts"]))
    return [math.radians(traffic["starts"][i]) for i in perm]


def intrinsics(camera: dict) -> np.ndarray:
    return np.array([[camera["fx"], 0.0, camera["cx"]], [0.0, camera["fy"], camera["cy"]],
                     [0.0, 0.0, 1.0]])


def episode_order(traffic: dict) -> list:
    """Index into the trajectory of each frame of the episode: the
    traffic's `splice` lists [first, end) stretches, in order."""
    order = []
    for first, end in traffic["splice"]:
        order += list(range(int(first), int(end)))
    return order


def episode_poses(traffic: dict, start: float) -> tuple[np.ndarray, list]:
    """(the trajectory's Twc poses, the episode's order) from the start
    angle `start` (radians)."""
    tr = traffic["trajectory"]
    if tr["kind"] != "circle":
        raise ValueError(f"unknown trajectory kind {tr['kind']!r}")
    poses = circle_trajectory(tr["frames"], radius=tr["radius"], revs=tr["revs"],
                              height_bob=tr["height_bob"], start=start)
    return poses, episode_order(traffic)


def render_frames(room: BoxRoom, K: np.ndarray, poses: np.ndarray, width: int, height: int,
                  device, depth_factor: float, chunk: int = 16) -> list:
    """(u8 image, f16 depth in meters) host arrays of each pose, as a sensor
    delivers them: the depth is rounded to the sensor's unit, 1 /
    `depth_factor` m (the camera's `DepthMapFactor`), as its 16-bit depth
    image holds it, and scaled to meters as the dataset loader does. The
    rays are cast in torch float64 on `device`, `chunk` poses per call,
    with `BoxRoom.render`'s arithmetic."""
    import torch

    dev = torch.device(device)
    f64 = torch.float64
    fx, fy, cx, cy = (float(K[0, 0]), float(K[1, 1]), float(K[0, 2]), float(K[1, 2]))
    v, u = torch.meshgrid(torch.arange(height, dtype=f64, device=dev),
                          torch.arange(width, dtype=f64, device=dev), indexing="ij")
    dirs_cam = torch.stack([(u - cx) / fx, (v - cy) / fy, torch.ones_like(u)], dim=-1)
    texs = torch.from_numpy(np.stack(room.textures)).to(dev)
    h, n = room.h, room.tex_size
    out = []
    for s in range(0, len(poses), chunk):
        T = torch.as_tensor(np.asarray(poses[s:s + chunk]), dtype=f64, device=dev)
        B = T.shape[0]
        R, o = T[:, :3, :3], T[:, :3, 3]
        dirs = torch.einsum("hwj,bij->bhwi", dirs_cam, R)
        best_t = torch.full((B, height, width), math.inf, dtype=f64, device=dev)
        gray = torch.zeros((B, height, width), dtype=torch.float32, device=dev)
        for face, (axis, sign) in enumerate(FACES):
            d = dirs[..., axis]
            t = (sign * h - o[:, axis, None, None]) / d
            hit = (t > 1e-6) & torch.isfinite(t)
            t = torch.where(hit, t, torch.ones_like(t))
            p = o[:, None, None, :] + t[..., None] * dirs
            other = [a for a in range(3) if a != axis]
            inside = (p[..., other[0]].abs() <= h) & (p[..., other[1]].abs() <= h)
            valid = hit & inside & (t < best_t)
            a = torch.clamp((p[..., other[0]] / (2 * h) + 0.5) * (n - 1), 0, n - 1.001)
            b = torch.clamp((p[..., other[1]] / (2 * h) + 0.5) * (n - 1), 0, n - 1.001)
            a0, b0 = a.long(), b.long()
            fa, fb = a - a0, b - b0
            a1, b1 = torch.clamp(a0 + 1, max=n - 1), torch.clamp(b0 + 1, max=n - 1)
            tex = texs[face]
            val = (tex[b0, a0] * (1 - fa) * (1 - fb) + tex[b0, a1] * fa * (1 - fb)
                   + tex[b1, a0] * (1 - fa) * fb + tex[b1, a1] * fa * fb)
            gray = torch.where(valid, val.to(torch.float32), gray)
            best_t = torch.where(valid, t, best_t)
        depth = best_t * dirs_cam[..., 2]
        depth = torch.where(torch.isfinite(depth), depth, torch.zeros_like(depth))
        depth = torch.clamp(torch.round(depth * depth_factor), 0, 65535) / depth_factor
        img = torch.clamp(gray, 0, 255).to(torch.uint8).cpu().numpy()
        dep = depth.to(torch.float16).cpu().numpy()
        out += [(img[i], dep[i]) for i in range(B)]
    return out


def episode_frames(room: BoxRoom, camera: dict, poses: np.ndarray, order: list,
                   device) -> list:
    """The episode's (u8 image, f16 depth) frames in order, from the
    configuration's `camera`."""
    idx = sorted(set(order))
    rendered = dict(zip(idx, render_frames(room, intrinsics(camera), poses[idx],
                                           camera["width"], camera["height"], device,
                                           camera["depth_map_factor"])))
    return [rendered[i] for i in order]
