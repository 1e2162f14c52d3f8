"""ctypes bindings for the native C++ dataset runtime (native/orbtpu_io.cpp).

Port of `orbslam_mapsave_tpu/io/native_loader.py`: libpng decode + background
prefetch threads, so image decode overlaps device compute. It loads the
repository's `native/liborbtpu_io.so`; where that library will not load on
this host (another libc or libpng), it builds the same source with the
flags of `native/Makefile` into `orbslam_mapsave_tpu_torch/_build/` at
first use. `native/` itself is never written. `available()` is False only
when neither can be had; callers then use the pure-Python `TUMDataset`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

_ROOT = Path(__file__).resolve().parents[2]
_SRC = _ROOT / "native" / "orbtpu_io.cpp"
_PREBUILT = _ROOT / "native" / "liborbtpu_io.so"
_BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.orbtpu_open_sequence.restype = ctypes.c_void_p
    lib.orbtpu_open_sequence.argtypes = [
        ctypes.c_char_p, ctypes.c_double, ctypes.POINTER(ctypes.c_int), ctypes.c_int,
    ]
    lib.orbtpu_sequence_shape.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
    ]
    lib.orbtpu_prefetch.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
    lib.orbtpu_read_frame.restype = ctypes.c_int
    lib.orbtpu_read_frame.argtypes = [
        ctypes.c_void_p, ctypes.c_int,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_double),
    ]
    lib.orbtpu_close.argtypes = [ctypes.c_void_p]
    return lib


def build() -> Path:
    """Compile native/orbtpu_io.cpp with native/Makefile's flags into
    _build/ (the file name holds the source hash); returns the library."""
    digest = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:12]
    out = _BUILD_DIR / f"liborbtpu_io_{digest}.so"
    if out.is_file():
        return out
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    subprocess.run(["g++", "-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall", str(_SRC),
                    "-o", str(tmp), "-shared", "-lpng", "-lz", "-pthread"],
                   check=True, capture_output=True, text=True)
    tmp.replace(out)
    return out


def _load_lib() -> ctypes.CDLL | None:
    try:
        return _bind(ctypes.CDLL(str(_PREBUILT)))
    except OSError:
        pass
    if shutil.which("g++") is None or not _SRC.is_file():
        return None
    try:
        return _bind(ctypes.CDLL(str(build())))
    except (OSError, subprocess.CalledProcessError):
        return None


_LIB = None
_TRIED = False


def get_lib():
    global _LIB, _TRIED
    if not _TRIED:
        _LIB = _load_lib()
        _TRIED = True
    return _LIB


def available() -> bool:
    return get_lib() is not None


class NativeTUMDataset:
    """Drop-in for `TUMDataset` with native decode + prefetch."""

    def __init__(self, root: str | Path, depth_factor: float = 5000.0,
                 n_workers: int = 2, prefetch: int = 4):
        lib = get_lib()
        if lib is None:
            raise RuntimeError(
                "liborbtpu_io.so neither loads nor builds (needs g++, libpng, zlib)")
        self._lib = lib
        n = ctypes.c_int(0)
        self._h = lib.orbtpu_open_sequence(
            str(root).encode(), float(depth_factor), ctypes.byref(n), n_workers)
        if not self._h:
            raise FileNotFoundError(f"no TUM sequence at {root}")
        self._n = n.value
        h, w = ctypes.c_int(0), ctypes.c_int(0)
        lib.orbtpu_sequence_shape(self._h, ctypes.byref(h), ctypes.byref(w))
        self.height, self.width = h.value, w.value
        self.prefetch_depth = prefetch
        self._lib.orbtpu_prefetch(self._h, 0, prefetch)

    def __len__(self):
        return self._n

    def __getitem__(self, i: int):
        gray = np.empty((self.height, self.width), np.float32)
        depth = np.empty((self.height, self.width), np.float32)
        ts = ctypes.c_double(0.0)
        rc = self._lib.orbtpu_read_frame(
            self._h, int(i),
            gray.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            depth.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            ctypes.byref(ts),
        )
        if rc != 0:
            raise IOError(f"native read_frame({i}) failed: {rc}")
        # keep the pipeline ahead of the consumer
        self._lib.orbtpu_prefetch(self._h, i + 1, self.prefetch_depth)
        # storage dtypes matching the Python loader: u8 gray + f16 depth
        return ts.value, gray.astype(np.uint8), (depth.astype(np.float16) if depth.any()
                                                 else None)

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.orbtpu_close(h)
            self._h = None
