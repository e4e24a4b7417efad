"""Native PointCloud2 ingestion (ctypes binding to ``csrc/host/pointcloud.cpp``).

Port of ``vision_semantic_segmentation_tpu/runtime/native_io.py``.  It
replaces the reference's per-point Python decode loop (ref
mapping.py:178-181) with a single-pass C++ decoder that emits the dense
(num_fields, N) layout, optionally already padded to a point bucket.

The library is the port's own copy of the JAX package's
``native/pointcloud.cpp``, built with the host C++ compiler at first use
(never at import) into ``build/host_libs/`` at the repo root; its file name
carries a hash of the source and flags, so an edited source rebuilds.  The
vectorized numpy decoder is its plain version.  Where the library cannot be
built or loaded, decoding goes through numpy, as in the JAX package, but
not quietly: one warning is logged, and :func:`native_available` says which
decoder runs.  ``calls`` counts the decodes each decoder made.
"""
from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "host" / "pointcloud.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "host_libs"
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17", "-Wall")
MAX_FIELDS = 16

# sensor_msgs/PointField datatype codes -> numpy dtypes
_FIELD_DTYPES = {
    1: np.int8, 2: np.uint8, 3: np.int16, 4: np.uint16,
    5: np.int32, 6: np.uint32, 7: np.float32, 8: np.float64,
}

calls: Dict[str, int] = {"native": 0, "numpy": 0}
_lock = threading.Lock()
_lib = None
_failure: Optional[str] = None
_log = logging.getLogger(__name__)


def library_path() -> Path:
    digest = hashlib.sha1(SOURCE.read_bytes())
    digest.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"pointcloud-{digest.hexdigest()[:16]}.so"


def _build(out: Path) -> None:
    cxx = os.environ.get("CXX") or shutil.which("c++") or shutil.which("g++")
    if cxx is None:
        raise RuntimeError("no host C++ compiler (c++ or g++) found")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True, timeout=120)
    if proc.returncode != 0:
        raise RuntimeError(f"{cxx} exit {proc.returncode}: {proc.stderr.strip()}")
    os.replace(tmp, out)


def _load_library():
    """The loaded library, or None (a failure is cached and warned once)."""
    global _lib, _failure
    with _lock:
        if _lib is not None or _failure is not None:
            return _lib
        try:
            out = library_path()
            if not out.exists():
                _build(out)
            lib = ctypes.CDLL(str(out))
        except (OSError, RuntimeError, subprocess.SubprocessError) as e:
            _failure = str(e)
            _log.warning("native PointCloud2 decoder unavailable (%s); decoding with numpy",
                         _failure)
            return None
        i64p, i32p = ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32)
        lib.decode_pointcloud2.restype = ctypes.c_int64
        lib.decode_pointcloud2.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64, i64p, i32p,
            ctypes.c_int64, ctypes.POINTER(ctypes.c_float), ctypes.c_int32,
        ]
        lib.decode_and_bucket.restype = ctypes.c_int64
        lib.decode_and_bucket.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64, i64p, i32p,
            ctypes.c_int64, ctypes.c_int64, ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int32,
        ]
        _lib = lib
        return lib


def _count(decoder: str) -> None:
    with _lock:  # decodes run on several threads (the decode-ahead feed)
        calls[decoder] += 1


def native_available() -> bool:
    """Whether decodes run the C++ library (building it on first call)."""
    return _load_library() is not None


def _numpy_decode(data: bytes, num_points: int, point_step: int, offsets: Sequence[int],
                  datatypes: Sequence[int], skip_nans: bool) -> np.ndarray:
    """Plain version: one strided view per field."""
    raw = np.frombuffer(data, dtype=np.uint8, count=num_points * point_step)
    raw = raw.reshape(num_points, point_step)
    cols = []
    for off, dt_code in zip(offsets, datatypes):
        dt = np.dtype(_FIELD_DTYPES[dt_code])
        field = raw[:, off : off + dt.itemsize].copy().view(dt.newbyteorder("<"))[:, 0]
        cols.append(field.astype(np.float32))
    out = np.stack(cols)
    if skip_nans:
        out = out[:, np.isfinite(out).all(axis=0)]
    return out


def _schema(offsets, datatypes):
    if len(offsets) > MAX_FIELDS:
        raise ValueError(f"at most {MAX_FIELDS} fields supported, got {len(offsets)}")
    off = np.asarray(offsets, dtype=np.int64)
    dts = np.asarray(datatypes, dtype=np.int32)
    return (off, dts, off.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            dts.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))


def decode_pointcloud2(data: bytes, num_points: int, point_step: int, offsets: Sequence[int],
                       datatypes: Sequence[int], skip_nans: bool = True) -> np.ndarray:
    """Decode a PointCloud2 payload into (num_fields, N) float32.

    Args mirror the message schema: byte ``offsets`` and PointField
    ``datatypes`` per requested field (e.g. x, y, z, intensity).
    """
    num_fields = len(offsets)
    keep = _schema(offsets, datatypes)
    lib = _load_library()
    if lib is None:
        _count("numpy")
        return _numpy_decode(data, num_points, point_step, offsets, datatypes, skip_nans)
    out = np.empty((num_fields, num_points), dtype=np.float32)
    written = lib.decode_pointcloud2(data, num_points, point_step, keep[2], keep[3], num_fields,
                                     out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                                     1 if skip_nans else 0)
    _count("native")
    # compact the NaN-skipped layout: field f occupies out[f, :written]
    if written != num_points:
        return np.stack([out[f, :written] for f in range(num_fields)])
    return out


def decode_and_bucket(data: bytes, num_points: int, point_step: int, offsets: Sequence[int],
                      datatypes: Sequence[int], bucket: int,
                      skip_nans: bool = True) -> Tuple[np.ndarray, np.ndarray]:
    """Decode + pad/truncate to a point bucket in one pass.

    Returns ((num_fields, bucket) float32, (bucket,) bool validity), the
    inputs of the fused mapping step.
    """
    num_fields = len(offsets)
    keep = _schema(offsets, datatypes)
    lib = _load_library()
    if lib is None:
        _count("numpy")
        dense = _numpy_decode(data, num_points, point_step, offsets, datatypes, skip_nans)
        n = min(dense.shape[1], bucket)
        out = np.zeros((num_fields, bucket), np.float32)
        out[:, :n] = dense[:, :n]
        valid = np.zeros((bucket,), bool)
        valid[:n] = True
        return out, valid
    out = np.empty((num_fields, bucket), dtype=np.float32)
    valid = np.empty((bucket,), dtype=np.uint8)
    lib.decode_and_bucket(data, num_points, point_step, keep[2], keep[3], num_fields, bucket,
                          out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                          valid.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                          1 if skip_nans else 0)
    _count("native")
    return out, valid.astype(bool)
