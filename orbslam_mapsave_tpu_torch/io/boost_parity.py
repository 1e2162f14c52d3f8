"""Boost-binary-archive map converter — reference format parity.

Port of `orbslam_mapsave_tpu/io/boost_parity.py`, which is numpy only: this
is the port's own copy of it, with the torch `MapState` turned into numpy
arrays on the way in (`save_boost_map`) and into tensors on a device the
caller names on the way out (`load_boost_map`). A file written by either
package is byte-identical to the other's for the same map.

The reference saves maps with `boost::archive::binary_oarchive(no_header)`
(`src/System.cc:556,568`). Record layout (SURVEY.md §5.4): `Map::save`
(`src/Map.cc:31-74`) writes

    [Map class preamble][i32 nPoints][MapPoint...][i32 nKFs][KeyFrame...]
    [i32 nOrigins][KeyFrame...][u64 mnMaxKFid][u32 0xdeadbeef]
    [dead tail: i32 nPoints + points again]

with `MapPoint::save` (`src/MapPoint.cc:58-140`) and `KeyFrame::save`
(`src/KeyFrame.cc:86-307`) emitting every field in declaration order —
including `mGrid` (the 64x48 per-cell feature-index grid), the
covisibility id/weight map, `mvpOrderedConnectedKeyFrames`,
`mvOrderedWeights` (vector<int>), `mbFirstConnection`, and the tail
`mbNotErase/mbToBeErased/mbBad/mHalfBaseline` (`src/KeyFrame.cc:240-307`).

## Boost binary-archive encoding rules (x86-64 Linux, boost >= 1.58 as in
## the reference's ROS-kinetic target; no_header so no magic preamble)

These rules are centralized in `_Writer`/`_Reader` so a byte-width
correction against a real boost build is a one-line change:

- primitives are raw little-endian: int=4B, unsigned int=4B, long=8B,
  long unsigned/size_t=8B, float=4B, double=8B, bool=1B;
- std::vector<T>: collection_size_type count (8B) + item_version (4B,
  `boost/serialization/vector.hpp` with BOOST_SERIALIZATION_VECTOR_VERSIONED)
  + payload. Arithmetic T uses the fast-array path (raw bytes); class T
  serializes each element;
- class types at implementation_level object_class_info (cv::Mat,
  cv::KeyPoint, vectors of class type, MapPoint/KeyFrame/Map themselves)
  write a ONE-TIME preamble at their first appearance in the archive:
  tracking flag (1B bool, 0 = not tracked) + class version (4B u32, 0)
  (`boost/archive/basic_oarchive.cpp::save_object`). Vectors of arithmetic
  types carry collection_traits (object_serializable) and write NO preamble;
- cv::Mat (`include/MapPoint.h:213-231`): cols i32, rows i32, elem_size
  u64, elem_type u64, raw data via make_array (no length prefix). A
  default-constructed Mat has elem_size=1, elem_type=CV_8U=0;
- cv::KeyPoint (`include/MapPoint.h:197-207`): angle f32, class_id i32,
  octave i32, response f32 TWICE [sic], x f32, y f32 — the reference's
  double-written response / missing size quirk, preserved verbatim.

The quirk set (`MapPoint::save` early-returns for bad points so the count
over-reports; `Map::save` writes the point block twice with the second copy
never read back) is reproduced on write and tolerated on read exactly like
`Map::load` (`src/Map.cc:76-133`).
"""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np
import torch

from ..slammap import mapstate as ms
from ..slammap.mapstate import MapState

TEST_DATA = 0xDEADBEEF
GRID_COLS = 64  # Frame.h:37
GRID_ROWS = 48  # Frame.h:38


class _Writer:
    def __init__(self):
        self.buf = bytearray()
        self._seen: set[str] = set()

    def i32(self, v):
        self.buf += struct.pack("<i", int(v))

    def u32(self, v):
        self.buf += struct.pack("<I", int(v) & 0xFFFFFFFF)

    def u64(self, v):
        self.buf += struct.pack("<Q", int(v))

    def i64(self, v):
        self.buf += struct.pack("<q", int(v))

    def f32(self, v):
        self.buf += struct.pack("<f", float(v))

    def f64(self, v):
        self.buf += struct.pack("<d", float(v))

    def boolean(self, v):
        self.buf += struct.pack("<?", bool(v))

    def raw(self, b):
        self.buf += bytes(b)

    def class_preamble(self, name: str):
        """First-encounter class info: tracking (1B, 0) + version (4B, 0)."""
        if name not in self._seen:
            self._seen.add(name)
            self.boolean(False)
            self.u32(0)

    def vec_header(self, count: int):
        """collection_size_type (8B) + item_version (4B)."""
        self.u64(count)
        self.u32(0)


class _Reader:
    def __init__(self, data: bytes):
        self.data = data
        self.off = 0
        self._seen: set[str] = set()

    def _take(self, fmt, n):
        v = struct.unpack_from(fmt, self.data, self.off)[0]
        self.off += n
        return v

    def i32(self):
        return self._take("<i", 4)

    def u32(self):
        return self._take("<I", 4)

    def u64(self):
        return self._take("<Q", 8)

    def i64(self):
        return self._take("<q", 8)

    def f32(self):
        return self._take("<f", 4)

    def f64(self):
        return self._take("<d", 8)

    def boolean(self):
        return self._take("<?", 1)

    def raw(self, n):
        b = self.data[self.off : self.off + n]
        self.off += n
        return b

    def class_preamble(self, name: str):
        if name not in self._seen:
            self._seen.add(name)
            self.boolean()
            self.u32()

    def vec_header(self) -> int:
        n = self.u64()
        self.u32()
        return n


# ---------------------------------------------------------------------------
# cv::Mat / cv::KeyPoint / std::vector encoders
# ---------------------------------------------------------------------------


def _write_mat(w: _Writer, arr: np.ndarray | None, elem_type: int):
    """cv::Mat serializer parity (`include/MapPoint.h:213-231`). None or a
    0-element array encodes the default-constructed Mat."""
    w.class_preamble("cv::Mat")
    if arr is None or arr.size == 0:
        w.i32(0)
        w.i32(0)
        w.u64(1)  # empty Mat: elemSize()=1
        w.u64(0)  # type()=CV_8U
        return
    arr = np.atleast_2d(arr)
    w.i32(arr.shape[1])  # cols
    w.i32(arr.shape[0])  # rows
    w.u64(arr.itemsize)  # elem_size
    w.u64(elem_type)  # cv type id (5=CV_32F, 0=CV_8U)
    w.raw(arr.tobytes())


def _read_mat(r: _Reader) -> np.ndarray:
    r.class_preamble("cv::Mat")
    cols = r.i32()
    rows = r.i32()
    elem_size = r.u64()
    elem_type = r.u64()
    data = r.raw(cols * rows * elem_size)
    dtype = {0: np.uint8, 5: np.float32, 6: np.float64}.get(elem_type & 7,
                                                            np.uint8)
    if cols * rows == 0:
        return np.zeros((rows, cols), dtype)
    return np.frombuffer(data, dtype).reshape(rows, cols).copy()


def _write_keypoint(w: _Writer, x, y, octave, angle, response):
    """cv::KeyPoint quirk parity: response TWICE, no size
    (`include/MapPoint.h:197-207`)."""
    w.class_preamble("cv::KeyPoint")
    w.f32(angle)
    w.i32(-1)  # class_id
    w.i32(octave)
    w.f32(response)
    w.f32(response)  # [sic] duplicated in the reference
    w.f32(x)
    w.f32(y)


def _read_keypoint(r: _Reader):
    r.class_preamble("cv::KeyPoint")
    angle = r.f32()
    r.i32()  # class_id
    octave = r.i32()
    response = r.f32()
    r.f32()  # duplicate response
    x = r.f32()
    y = r.f32()
    return x, y, octave, angle, response


def _write_kp_vector(w: _Writer, kps):
    w.class_preamble("vector<cv::KeyPoint>")
    w.vec_header(len(kps))
    for kp in kps:
        _write_keypoint(w, *kp)


def _read_kp_vector(r: _Reader):
    r.class_preamble("vector<cv::KeyPoint>")
    n = r.vec_header()
    return [_read_keypoint(r) for _ in range(n)]


def _write_f32_vector(w: _Writer, vals):
    # vector<float>: primitive collection -> no class preamble, fast array
    w.vec_header(len(vals))
    w.raw(np.asarray(vals, np.float32).tobytes())


def _read_f32_vector(r: _Reader):
    n = r.vec_header()
    return np.frombuffer(r.raw(4 * n), np.float32).copy()


def _write_i32_vector(w: _Writer, vals):
    w.vec_header(len(vals))
    w.raw(np.asarray(vals, np.int32).tobytes())


def _read_i32_vector(r: _Reader):
    n = r.vec_header()
    return np.frombuffer(r.raw(4 * n), np.int32).copy()


def _write_grid(w: _Writer, grid: list[list[list[int]]]):
    """mGrid = vector<vector<vector<size_t>>> (`src/KeyFrame.cc:180` region):
    outer = 64 columns, inner = 48 rows, cells = feature indices."""
    w.class_preamble("vector<vector<vector<size_t>>>")
    w.vec_header(len(grid))
    for col in grid:
        w.class_preamble("vector<vector<size_t>>")
        w.vec_header(len(col))
        for cell in col:
            # vector<size_t>: primitive collection, fast array
            w.vec_header(len(cell))
            w.raw(np.asarray(cell, np.uint64).tobytes())


def _read_grid(r: _Reader) -> list[list[list[int]]]:
    r.class_preamble("vector<vector<vector<size_t>>>")
    n_cols = r.vec_header()
    grid = []
    for _ in range(n_cols):
        r.class_preamble("vector<vector<size_t>>")
        n_rows = r.vec_header()
        col = []
        for _ in range(n_rows):
            n = r.vec_header()
            col.append(list(np.frombuffer(r.raw(8 * n), np.uint64)))
        grid.append(col)
    return grid


def _compute_grid(xy: np.ndarray, valid_rows: np.ndarray, width: float,
                  height: float) -> list[list[list[int]]]:
    """`Frame::AssignFeaturesToGrid` + `PosInGrid` (`src/Frame.cc:341-380`):
    cell = round((x - minX) * gridElementWidthInv), indices are positions in
    the compacted (valid-only) keypoint vector."""
    inv_w = GRID_COLS / width
    inv_h = GRID_ROWS / height
    grid = [[[] for _ in range(GRID_ROWS)] for _ in range(GRID_COLS)]
    for i, row in enumerate(valid_rows):
        x, y = xy[row]
        cx = int(round(x * inv_w))
        cy = int(round(y * inv_h))
        if 0 <= cx < GRID_COLS and 0 <= cy < GRID_ROWS:
            grid[cx][cy].append(i)
    return grid


# ---------------------------------------------------------------------------
# Map / MapPoint / KeyFrame records
# ---------------------------------------------------------------------------


def save_boost_map(path: str | Path, state: MapState, cam_params=None,
                   scale_factor: float = 1.5, n_levels: int = 4,
                   ts_epoch: float = 0.0) -> None:
    """Write a MapState in the reference's archive layout
    (`Map::save`, `src/Map.cc:31-74`). `ts_epoch` is added to each f32
    offset stamp so the archive carries ABSOLUTE f64 timestamps, matching
    the reference's double mTimeStamp (`src/KeyFrame.cc:100`)."""
    state = MapState(*[x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)
                       for x in state])
    w = _Writer()
    kf_valid = np.asarray(state.kf_valid)
    pt_valid = np.asarray(state.pt_valid)
    kf_ids = np.nonzero(kf_valid)[0]
    pt_ids = np.nonzero(pt_valid)[0]
    cam = cam_params or {}

    w.class_preamble("Map")  # top-level `ar << *mpMap` object info

    def write_points():
        w.i32(len(pt_ids))
        first = True
        for p in pt_ids:
            w.class_preamble("MapPoint")
            _write_mappoint(w, state, int(p))
            first = False
        del first

    write_points()
    w.i32(len(kf_ids))
    for k in kf_ids:
        w.class_preamble("KeyFrame")
        _write_keyframe(w, state, int(k), cam, scale_factor, n_levels, ts_epoch)
    # origins: the first keyframe (Map.cc mvpKeyFrameOrigins)
    n_orig = 1 if len(kf_ids) else 0
    w.i32(n_orig)
    if n_orig:
        _write_keyframe(w, state, int(kf_ids[0]), cam, scale_factor, n_levels, ts_epoch)
    w.u64(int(np.max(kf_ids)) if len(kf_ids) else 0)  # mnMaxKFid
    w.u32(TEST_DATA)
    write_points()  # dead tail, never read back (Map.cc:68-73)
    Path(path).write_bytes(bytes(w.buf))


def _write_mappoint(w: _Writer, state: MapState, p: int):
    """`MapPoint::save` field order (`src/MapPoint.cc:58-140`)."""
    w.u64(p)  # mnId
    w.u64(int(state.n_pt))  # nNextId
    w.i64(int(state.pt_first_kf[p]))  # mnFirstKFid
    w.i64(0)  # mnFirstFrame
    w.i32(int(np.sum(np.asarray(state.pt_obs_kf[p]) >= 0)))  # nObs
    w.f32(0.0)  # mTrackProjX
    w.f32(0.0)  # mTrackProjY
    w.f32(0.0)  # mTrackProjXR
    w.boolean(False)  # mbTrackInView
    w.i32(0)  # mnTrackScaleLevel
    w.f32(0.0)  # mTrackViewCos
    for _ in range(7):  # mnTrackReferenceForFrame..mnCorrectedReference
        w.u64(0)
    _write_mat(w, None, 5)  # mPosGBA (default-constructed)
    w.u64(0)  # mnBAGlobalForKF
    _write_mat(w, np.asarray(state.pt_pos[p], np.float32).reshape(3, 1), 5)
    # observations as {bool, KFid u64, featIdx u64}
    obs_kf = np.asarray(state.pt_obs_kf[p])
    obs_ix = np.asarray(state.pt_obs_idx[p])
    sel = obs_kf >= 0
    w.u32(int(sel.sum()))  # nItems (unsigned int in MapPoint::save)
    order = np.argsort(obs_kf[sel])  # std::map iterates in key order
    for kf, ix in zip(obs_kf[sel][order], obs_ix[sel][order]):
        w.boolean(True)
        w.u64(int(kf))
        w.u64(int(ix))
    _write_mat(w, np.asarray(state.pt_normal[p], np.float32).reshape(3, 1), 5)
    _write_mat(w, np.asarray(state.pt_desc[p], np.uint8).reshape(1, 32), 0)
    ref = int(state.pt_ref_kf[p])
    if ref >= 0:
        w.boolean(True)
        w.u64(ref)
    else:
        w.boolean(False)
    w.i32(int(state.pt_visible[p]))
    w.i32(int(state.pt_found[p]))
    w.boolean(False)  # mbBad
    w.f32(float(state.pt_min_dist[p]))
    w.f32(float(state.pt_max_dist[p]))


def _write_keyframe(w: _Writer, state: MapState, k: int, cam: dict,
                    scale_factor: float, n_levels: int,
                    ts_epoch: float = 0.0):
    """`KeyFrame::save` field order (`src/KeyFrame.cc:86-307`)."""
    N = state.n_features
    valid = np.asarray(state.kf_kp_valid[k])
    valid_rows = np.nonzero(valid)[0]
    width = cam.get("width", 640)
    height = cam.get("height", 480)
    w.u64(int(state.n_kf))  # nNextId (static, long unsigned)
    w.u64(k)  # mnId
    w.u64(int(state.kf_frame_id[k]))  # mnFrameId
    w.f64(float(state.kf_timestamp[k]) + ts_epoch)
    w.i32(GRID_COLS)  # mnGridCols (Frame.h:37)
    w.i32(GRID_ROWS)  # mnGridRows
    w.f32(GRID_COLS / width)  # mfGridElementWidthInv
    w.f32(GRID_ROWS / height)  # mfGridElementHeightInv
    for _ in range(5):  # mnTrackReferenceForFrame..mnLoopQuery
        w.u64(0)
    w.i32(0)  # mnLoopWords
    w.f32(0.0)  # mLoopScore
    w.u64(0)  # mnRelocQuery
    w.i32(0)  # mnRelocWords
    w.f32(0.0)  # mRelocScore
    _write_mat(w, None, 5)  # mTcwGBA (default-constructed)
    _write_mat(w, None, 5)  # mTcwBefGBA
    w.u64(0)  # mnBAGlobalForKF
    fx = cam.get("fx", 1.0)
    fy = cam.get("fy", 1.0)
    w.f32(fx)
    w.f32(fy)
    w.f32(cam.get("cx", 0.0))
    w.f32(cam.get("cy", 0.0))
    w.f32(1.0 / fx)
    w.f32(1.0 / fy)
    w.f32(cam.get("bf", 0.0))
    w.f32(cam.get("bf", 0.0) / fx)  # mb
    w.f32(cam.get("th_depth", 0.0))
    n_valid = int(valid.sum())
    w.i32(n_valid)  # N
    xy = np.asarray(state.kf_kp_xy[k])
    octv = np.asarray(state.kf_kp_octave[k])
    ang = np.asarray(state.kf_kp_angle[k])
    kps = [
        (xy[i, 0], xy[i, 1], int(octv[i]), float(ang[i]), 0.0)
        for i in range(N) if valid[i]
    ]
    _write_kp_vector(w, kps)  # mvKeys (raw coords unavailable: und used)
    _write_kp_vector(w, kps)  # mvKeysUn
    _write_f32_vector(w, np.asarray(state.kf_kp_ur[k])[valid])
    _write_f32_vector(w, np.asarray(state.kf_kp_depth[k])[valid])
    _write_mat(w, np.asarray(state.kf_desc[k])[valid], 0)  # mDescriptors
    _write_mat(w, None, 5)  # mTcp (set only by SetBadFlag; default empty)
    w.i32(n_levels)  # mnScaleLevels
    w.f32(scale_factor)
    w.f32(float(np.log(scale_factor)))
    sf = np.array([scale_factor**i for i in range(n_levels)], np.float32)
    _write_f32_vector(w, sf)
    _write_f32_vector(w, sf**2)
    _write_f32_vector(w, 1.0 / sf**2)
    w.i32(0)  # mnMinX
    w.i32(0)  # mnMinY
    w.i32(int(width))  # mnMaxX
    w.i32(int(height))  # mnMaxY
    K = np.array([[fx, 0, cam.get("cx", 0.0)], [0, fy, cam.get("cy", 0.0)],
                  [0, 0, 1]], np.float32)
    _write_mat(w, K, 5)
    Tcw = np.asarray(state.kf_pose[k], np.float32)
    Twc = np.linalg.inv(Tcw).astype(np.float32)
    _write_mat(w, Tcw, 5)
    _write_mat(w, Twc, 5)
    _write_mat(w, Twc[:3, 3].reshape(3, 1), 5)  # Ow
    _write_mat(w, Twc[:3, 3].reshape(3, 1), 5)  # Cw (stereo center; = Ow mono)
    # map point ids per feature ({bool is_id, u64 id}, KeyFrame.cc:152-176)
    fwd = np.asarray(state.kf_kp_point[k])[valid]
    w.i32(len(fwd))
    for pid in fwd:
        if pid < 0:
            w.boolean(False)
        else:
            w.boolean(True)
            w.u64(int(pid))
    # mGrid (KeyFrame.cc:180 region)
    _write_grid(w, _compute_grid(xy, valid_rows, width, height))
    # connected keyframe weights {bool, u64 id, i32 weight} — std::map
    # iterates by pointer key; id order is the reproducible stand-in
    covis = np.asarray(state.covis[k])
    conn = np.nonzero(covis > 0)[0]
    w.i32(len(conn))
    for j in conn:
        w.boolean(True)
        w.u64(int(j))
        w.i32(int(covis[j]))
    # ordered covisibles (ids by descending weight, ties by id like
    # UpdateBestCovisibles' stable sort)
    order = conn[np.argsort(-covis[conn], kind="stable")]
    w.i32(len(order))
    for j in order:
        w.boolean(True)
        w.u64(int(j))
    # mvOrderedWeights as vector<int> (KeyFrame.cc:240 `ar & mvOrderedWeights`)
    _write_i32_vector(w, covis[order].astype(np.int32))
    # spanning tree
    parent = int(state.kf_parent[k])
    # mbFirstConnection: cleared by the first UpdateConnections that assigns
    # a parent (`src/KeyFrame.cc:1092-1097`); stays true for KF 0 forever
    w.boolean(k == 0 or parent < 0)
    if parent >= 0:
        w.boolean(True)
        w.u64(parent)
    else:
        w.boolean(False)
    children = np.nonzero(np.asarray(state.kf_parent) == k)[0]
    children = children[np.asarray(state.kf_valid)[children]]
    w.i32(len(children))
    for c in children:
        w.boolean(True)
        w.u64(int(c))
    loops = np.asarray(state.kf_loop_edges[k])
    loops = loops[loops >= 0]
    w.i32(len(loops))
    for l in loops:
        w.boolean(True)
        w.u64(int(l))
    # tail flags (KeyFrame.cc:292-296)
    w.boolean(False)  # mbNotErase
    w.boolean(False)  # mbToBeErased
    w.boolean(False)  # mbBad
    w.f32(cam.get("bf", 0.0) / fx / 2.0)  # mHalfBaseline


def load_boost_map(path: str | Path, max_keyframes: int = 512,
                   max_points: int = 65536, n_features: int = 2048,
                   ts_epoch: float = 0.0, device="cpu") -> MapState:
    """Read the archive back into a MapState on `device` (`Map::load`,
    `src/Map.cc:76-133` + the System rebinding passes `System.cc:148-195`,
    which collapse to array writes here)."""
    r = _Reader(Path(path).read_bytes())
    r.class_preamble("Map")
    n_pts = r.i32()
    points = []
    for _ in range(n_pts):
        r.class_preamble("MapPoint")
        points.append(_read_mappoint(r))
    n_kfs = r.i32()
    kfs = []
    for _ in range(n_kfs):
        r.class_preamble("KeyFrame")
        kfs.append(_read_keyframe(r))
    n_orig = r.i32()
    for _ in range(n_orig):
        _read_keyframe(r)
    max_kf_id = r.u64()
    sentinel = r.u32()
    if sentinel != TEST_DATA:
        raise ValueError(f"sentinel mismatch: {sentinel:#x}")
    del max_kf_id  # dead tail after this is ignored, like Map::load

    state = ms.empty_map(max_keyframes, max_points, n_features)
    state_np = {k: v.numpy().copy() for k, v in state._asdict().items()}
    for kf in kfs:
        k = kf["id"]
        n = min(len(kf["kps"]), n_features)
        state_np["kf_valid"][k] = True
        state_np["kf_timestamp"][k] = kf["timestamp"] - ts_epoch
        state_np["kf_frame_id"][k] = kf["frame_id"]
        state_np["kf_pose"][k] = kf["Tcw"]
        for i in range(n):
            x, y, octave, angle, resp = kf["kps_un"][i]
            state_np["kf_kp_xy"][k, i] = (x, y)
            state_np["kf_kp_octave"][k, i] = octave
            state_np["kf_kp_angle"][k, i] = angle
            state_np["kf_kp_valid"][k, i] = True
        state_np["kf_kp_ur"][k, :n] = kf["ur"][:n]
        state_np["kf_kp_depth"][k, :n] = kf["depth"][:n]
        state_np["kf_desc"][k, :n] = kf["desc"][:n]
        state_np["kf_kp_point"][k, :n] = kf["points"][:n]
        for j, wgt in kf["connections"]:
            state_np["covis"][k, j] = wgt
        state_np["kf_parent"][k] = kf["parent"]
        for i, l in enumerate(kf["loops"][: ms.MAX_LOOP_EDGES]):
            state_np["kf_loop_edges"][k, i] = l
    for pt in points:
        p = pt["id"]
        state_np["pt_valid"][p] = True
        state_np["pt_pos"][p] = pt["pos"]
        state_np["pt_normal"][p] = pt["normal"]
        state_np["pt_desc"][p] = pt["desc"]
        state_np["pt_ref_kf"][p] = pt["ref_kf"]
        state_np["pt_first_kf"][p] = pt["first_kf"]
        state_np["pt_visible"][p] = pt["visible"]
        state_np["pt_found"][p] = pt["found"]
        state_np["pt_min_dist"][p] = pt["min_dist"]
        state_np["pt_max_dist"][p] = pt["max_dist"]
        for lane, (kf, ix) in enumerate(pt["obs"][: ms.MAX_OBS]):
            state_np["pt_obs_kf"][p, lane] = kf
            state_np["pt_obs_idx"][p, lane] = ix
            state_np["pt_obs_oct"][p, lane] = np.int8(
                state_np["kf_kp_octave"][kf, ix]
            )
    state_np["n_kf"] = np.int32(max((kf["id"] for kf in kfs), default=-1) + 1)
    state_np["n_pt"] = np.int32(max((pt["id"] for pt in points), default=-1) + 1)
    return MapState(**{k: torch.from_numpy(np.array(v)).to(device)
                       for k, v in state_np.items()})


def _read_mappoint(r: _Reader) -> dict:
    out = {}
    out["id"] = r.u64()
    r.u64()  # nNextId
    out["first_kf"] = r.i64()
    r.i64()  # mnFirstFrame
    r.i32()  # nObs
    r.f32()
    r.f32()
    r.f32()
    r.boolean()
    r.i32()
    r.f32()
    for _ in range(7):
        r.u64()
    _read_mat(r)  # mPosGBA
    r.u64()
    out["pos"] = _read_mat(r).ravel()
    n_obs = r.u32()
    obs = []
    for _ in range(n_obs):
        if r.boolean():
            kf = r.u64()
            ix = r.u64()
            obs.append((kf, ix))
    out["obs"] = obs
    out["normal"] = _read_mat(r).ravel()
    out["desc"] = _read_mat(r).ravel()
    out["ref_kf"] = r.u64() if r.boolean() else -1
    out["visible"] = r.i32()
    out["found"] = r.i32()
    r.boolean()  # mbBad
    out["min_dist"] = r.f32()
    out["max_dist"] = r.f32()
    return out


def _read_keyframe(r: _Reader) -> dict:
    out = {}
    r.u64()  # nNextId
    out["id"] = r.u64()
    out["frame_id"] = r.u64()
    out["timestamp"] = r.f64()
    r.i32()  # mnGridCols
    r.i32()  # mnGridRows
    r.f32()
    r.f32()
    for _ in range(5):
        r.u64()
    r.i32()
    r.f32()
    r.u64()
    r.i32()
    r.f32()
    _read_mat(r)  # mTcwGBA
    _read_mat(r)  # mTcwBefGBA
    r.u64()
    for _ in range(9):  # fx..mThDepth
        r.f32()
    r.i32()  # N
    out["kps"] = _read_kp_vector(r)  # mvKeys
    out["kps_un"] = _read_kp_vector(r)
    out["ur"] = _read_f32_vector(r)
    out["depth"] = _read_f32_vector(r)
    out["desc"] = _read_mat(r)
    _read_mat(r)  # mTcp
    r.i32()  # levels
    r.f32()
    r.f32()
    _read_f32_vector(r)
    _read_f32_vector(r)
    _read_f32_vector(r)
    r.i32()
    r.i32()
    r.i32()
    r.i32()
    _read_mat(r)  # mK
    out["Tcw"] = _read_mat(r)
    _read_mat(r)  # Twc
    _read_mat(r)  # Ow
    _read_mat(r)  # Cw
    n = r.i32()
    pts = np.full(n, -1, np.int64)
    for i in range(n):
        if r.boolean():
            pts[i] = r.u64()
    out["points"] = pts
    out["grid"] = _read_grid(r)
    n = r.i32()
    conns = []
    for _ in range(n):
        if r.boolean():
            j = r.u64()
            wgt = r.i32()
            conns.append((j, wgt))
    out["connections"] = conns
    n = r.i32()
    ordered = []
    for _ in range(n):
        if r.boolean():
            ordered.append(r.u64())
    out["ordered"] = ordered
    out["ordered_weights"] = list(_read_i32_vector(r))
    out["first_connection"] = r.boolean()  # mbFirstConnection
    out["parent"] = r.u64() if r.boolean() else -1
    n = r.i32()
    children = []
    for _ in range(n):
        if r.boolean():
            children.append(r.u64())
    out["children"] = children
    n = r.i32()
    loops = []
    for _ in range(n):
        if r.boolean():
            loops.append(r.u64())
    out["loops"] = loops
    r.boolean()  # mbNotErase
    r.boolean()  # mbToBeErased
    r.boolean()  # mbBad
    out["half_baseline"] = r.f32()  # mHalfBaseline
    return out
