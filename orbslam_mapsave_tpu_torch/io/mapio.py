"""Map save / load: the fork's signature feature (`System::SaveMap/LoadMap`,
`src/System.cc:552-574`).

Port of `orbslam_mapsave_tpu/io/mapio.py`, format `orbtpu-map-v1`: a zip of
`.npy` files, one per MapState field under its name, plus `__meta__.json`
(version, the 0xDEADBEEF sentinel of `Map.cc:22,66`, capacities, counters,
the f64 timestamp epoch) and optionally the per-keyframe sparse BoW rows
(`__bow_word__`, `__bow_weight__`, keyed by the vocabulary's word count).
The arrays are written as numpy gives them, so a map saved by either
package loads in the other with every array equal, dtype and value. The
reference-format (boost archive) converter is `boost_parity.py`.
"""

from __future__ import annotations

import io
import json
import zipfile
from pathlib import Path

import numpy as np
import torch

from ..slammap.mapstate import MapState
from ..vocab.database import SparseBowStore

FORMAT_VERSION = "orbtpu-map-v1"
SENTINEL = 0xDEADBEEF  # Map.cc:22,66


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def save_map(path: str | Path, state: MapState, ts_epoch: float = 0.0,
             bow_store: SparseBowStore | None = None,
             voc_n_words: int | None = None) -> None:
    """Write the whole map state (`System::SaveMap`). `ts_epoch`: the run's
    f64 timestamp epoch (the device's `kf_timestamp` holds f32 offsets from
    it). `bow_store` with `voc_n_words`: the per-keyframe BoW rows, which
    a load with the same vocabulary uses instead of rebuilding them (the
    reference always rebuilds, `src/System.cc:162-163`)."""
    arrays = {k: _np(v) for k, v in state._asdict().items()}
    meta = {
        "version": FORMAT_VERSION,
        "sentinel": SENTINEL,
        "kf_capacity": int(state.kf_capacity),
        "pt_capacity": int(state.pt_capacity),
        "n_features": int(state.n_features),
        "n_kf": int(state.n_kf),
        "n_pt": int(state.n_pt),
        "ts_epoch": float(ts_epoch),
    }
    if bow_store is not None and voc_n_words is not None:
        meta["bow_n_words"] = int(voc_n_words)
        arrays["__bow_word__"] = _np(bow_store.word)
        arrays["__bow_weight__"] = _np(bow_store.weight)
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as zf:
        zf.writestr("__meta__.json", json.dumps(meta))
        for k, v in arrays.items():
            buf = io.BytesIO()
            np.save(buf, v)
            zf.writestr(f"{k}.npy", buf.getvalue())


def _meta(zf: zipfile.ZipFile) -> dict:
    return json.loads(zf.read("__meta__.json"))


def load_map(path: str | Path, device="cpu") -> MapState:
    """Read a map file onto `device` (`System::LoadMap`); checks the version
    and the sentinel as `Map::load` does (`src/Map.cc:127-131`)."""
    with zipfile.ZipFile(Path(path), "r") as zf:
        meta = _meta(zf)
        if meta.get("sentinel") != SENTINEL or meta.get("version") != FORMAT_VERSION:
            raise ValueError(f"bad map file {path}: version={meta.get('version')!r}")
        names = set(zf.namelist())
        fields = {k: np.load(io.BytesIO(zf.read(f"{k}.npy"))) if f"{k}.npy" in names else None
                  for k in MapState._fields}
    if fields["pt_obs_oct"] is None:
        # maps written before the denormalized octave column: derive it
        okf, oix = fields["pt_obs_kf"], fields["pt_obs_idx"]
        ok = okf >= 0
        oct_ = np.full(okf.shape, -1, np.int8)
        oct_[ok] = fields["kf_kp_octave"][okf[ok], oix[ok]].astype(np.int8)
        fields["pt_obs_oct"] = oct_
    if fields["n_obs_dropped"] is None:
        fields["n_obs_dropped"] = np.int32(0)  # files from before the counter
    return MapState(**{k: torch.from_numpy(np.array(v)).to(device) for k, v in fields.items()})


def load_bow_store(path: str | Path, voc_n_words: int, device="cpu") -> SparseBowStore | None:
    """The persisted BoW rows, or None when the file has none or was saved
    with another vocabulary (word ids belong to one vocabulary: the caller
    then rebuilds, `src/System.cc:162-163`)."""
    with zipfile.ZipFile(Path(path), "r") as zf:
        meta = _meta(zf)
        if meta.get("bow_n_words") != int(voc_n_words) or "__bow_word__.npy" not in zf.namelist():
            return None
        word = np.load(io.BytesIO(zf.read("__bow_word__.npy")))
        weight = np.load(io.BytesIO(zf.read("__bow_weight__.npy")))
    return SparseBowStore(word=torch.from_numpy(word).to(device),
                          weight=torch.from_numpy(weight).to(device))


def read_ts_epoch(path: str | Path) -> float:
    """The f64 timestamp epoch a map was saved with (0.0 for old files)."""
    with zipfile.ZipFile(Path(path), "r") as zf:
        return float(_meta(zf).get("ts_epoch", 0.0))


def map_summary(state: MapState) -> dict:
    """Counts the reference prints on save / load (`Map.cc:37,88`)."""
    return {
        "n_keyframes": int(state.kf_valid.sum()),
        "n_points": int(state.pt_valid.sum()),
        "n_observations": int((state.pt_obs_kf >= 0).sum()),
        "max_kf_slot": int(state.n_kf),
        "max_pt_slot": int(state.n_pt),
    }
