"""Carry state between the JAX package and this port as numpy arrays.

The port has no learned weights; its state is the map (`MapState`), the
BoW database (`SparseBowStore`), the frame (`FrameData`) and the tracker's
`ControlState`. (A vocabulary moves as a `.bin` file, which either
package writes and the other loads.) A JAX pytree fetched
as `{field: np.asarray(x)}` (or any NamedTuple of array-likes) turns into
the port's structure on a given device, and back. The parity tests use
this to hand both sides the same map and frame. numpy and torch only.
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
