"""Carry state between the JAX package and this port as numpy arrays.

The SLAM state is the map (`MapState`), the BoW database
(`SparseBowStore`), the frame (`FrameData`) and the tracker's
`ControlState`. (A vocabulary moves as a `.bin` file, which either
package writes and the other loads.) A JAX pytree fetched
as `{field: np.asarray(x)}` (or any NamedTuple of array-likes) turns into
the port's structure on a given device, and back. The one learned model,
the pose backbone (`models.pose_net`), moves as its flax parameter tree
flattened to "/"-joined paths (the npz format both packages' `save_params`
write) and the port's `state_dict`. The parity tests use this to hand
both sides the same map, frame and weights. numpy and torch only.
"""

from __future__ import annotations

import numpy as np
import torch

from .pipeline.frame import FrameData
from .pipeline.fused_step import ControlState
from .slammap.mapstate import MapState
from .vocab.database import SparseBowStore


def _fields(src) -> dict:
    return src._asdict() if hasattr(src, "_asdict") else dict(src)


def _tensor(x, device) -> torch.Tensor:
    return torch.from_numpy(np.array(np.asarray(x))).to(device)


def map_state_from_numpy(src, device="cpu") -> MapState | SparseBowStore:
    """A MapState — or a SparseBowStore, when src has exactly its fields
    (word, weight)."""
    d = _fields(src)
    cls = SparseBowStore if set(d) == set(SparseBowStore._fields) else MapState
    return cls(**{k: _tensor(d[k], device) for k in cls._fields})


def frame_from_numpy(src, device="cpu") -> FrameData:
    d = _fields(src)
    return FrameData(**{k: _tensor(d[k], device) for k in FrameData._fields})


_CTRL_HOST = {"mode": int, "has_velocity": bool, "ref_kf": int, "frame_id": int,
              "last_kf_frame_id": int, "recent_start": int, "allow_kf": bool,
              "mb_vo": bool}


def control_from_numpy(src, device="cpu") -> ControlState:
    d = _fields(src)
    out = {}
    for k in ControlState._fields:
        if k in _CTRL_HOST:
            out[k] = _CTRL_HOST[k](np.asarray(d[k]))
        elif k == "last_frame":
            out[k] = frame_from_numpy(d[k], device)
        else:
            out[k] = _tensor(d[k], device)
    return ControlState(**out)


def _numpy(t) -> np.ndarray:
    return t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


def map_state_to_numpy(state: MapState | SparseBowStore) -> dict:
    return {k: _numpy(v) for k, v in state._asdict().items()}


def frame_to_numpy(frame: FrameData) -> dict:
    return {k: _numpy(v) for k, v in frame._asdict().items()}


def control_to_numpy(ctrl: ControlState) -> dict:
    out = {k: _numpy(v) for k, v in ctrl._asdict().items() if k != "last_frame"}
    out["last_frame"] = frame_to_numpy(ctrl.last_frame)
    return out


def _pose_net_names(flax_key: str) -> tuple[str, str]:
    """("params/ConvBlock_3/GroupNorm_0/scale", ...) -> ("blocks.3.norm",
    "weight"): the torch module path and parameter name of a flax leaf."""
    parts = flax_key.split("/")
    if parts[0] == "params":
        parts = parts[1:]
    leaf = parts[-1]
    if parts[0].startswith("ConvBlock_"):
        i = int(parts[0].split("_")[1])
        mod = f"blocks.{i}." + ("conv" if parts[1].startswith("Conv") else "norm")
    else:
        mod = {"Conv_0": "context", "Conv_1": "head"}[parts[0]]
    return mod, {"kernel": "weight", "scale": "weight", "bias": "bias"}[leaf]


def pose_net_params_from_flax(flat: dict) -> dict:
    """The PoseNet `state_dict` (torch tensors) from a "/"-keyed dict of its
    flax parameters: the flattened flax tree or a `save_params` npz
    (`__meta__` is skipped). Conv kernels go HWIO -> OIHW; GroupNorm
    scale / bias become the norm's weight / bias."""
    out = {}
    for key, v in flat.items():
        if key == "__meta__":
            continue
        mod, name = _pose_net_names(key)
        v = np.asarray(v, np.float32)
        if v.ndim == 4:
            v = v.transpose(3, 2, 0, 1)
        out[f"{mod}.{name}"] = torch.from_numpy(np.array(v))
    return out


def pose_net_params_to_flax(state_dict: dict) -> dict:
    """Inverse of `pose_net_params_from_flax`: "params/..."-keyed float32
    numpy arrays in flax's layout."""
    out = {}
    for key, v in state_dict.items():
        mod, name = key.rsplit(".", 1)
        v = _numpy(v).astype(np.float32)
        if mod.startswith("blocks."):
            i, kind = mod.split(".")[1:]
            path = f"ConvBlock_{i}/" + ("Conv_0" if kind == "conv" else "GroupNorm_0")
        else:
            path = {"context": "Conv_0", "head": "Conv_1"}[mod]
        if v.ndim == 4:
            leaf = "kernel"
            v = v.transpose(2, 3, 1, 0)
        elif name == "weight":
            leaf = "scale"
        else:
            leaf = "bias"
        out[f"params/{path}/{leaf}"] = np.ascontiguousarray(v)
    return out
