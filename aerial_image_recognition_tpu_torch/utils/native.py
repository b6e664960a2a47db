"""ctypes loaders for the native host helpers (on-demand g++ builds).

A copy of ``aerial_image_recognition_tpu/utils/native.py`` over the port's
own copies of the sources (``native/fastgeo.cpp``, ``native/fastdecode.cpp``
beside this package, and ``native/fastpack.cpp``, the reference's quad-layout
packer of ``fastdecode.cpp`` in a source that builds without libjpeg). Each library is compiled on first use into the
repository's ``build/native/lib<name>-<hash>.so``, never next to the source;
the hash covers the source and the flags, so an edited source is rebuilt
and a stale library is never loaded. The flags are portable (no
``-march=native``: a checkout may move between machines with its
``build/``) and keep floating-point contraction off, so the dedup distance
test rounds as numpy's does.

Everything degrades as the reference's does: without a compiler (or
libjpeg, for the decoder) the loaders return None and the callers take
their numpy / PIL paths, which give the same results (tests hold the two paths equal).
``native_paths()`` says which libraries loaded.
"""

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional

import numpy as np

_SRC_DIR = Path(__file__).resolve().parent.parent / "native"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CXX_FLAGS = ("-O3", "-ffp-contract=off", "-shared", "-fPIC")
_LINK = {"fastgeo": (), "fastdecode": ("-ljpeg",), "fastpack": ()}

_lock = threading.Lock()
_libs: Dict[str, Optional[ctypes.CDLL]] = {}


def _target(name: str) -> Path:
    src = (_SRC_DIR / f"{name}.cpp").read_bytes()
    flags = " ".join(CXX_FLAGS + _LINK[name]).encode()
    digest = hashlib.sha256(src + flags).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _build(name: str, target: Path) -> bool:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
    cmd = ["g++", *CXX_FLAGS, str(_SRC_DIR / f"{name}.cpp"), *_LINK[name],
           "-o", str(tmp)]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, target)          # atomic: concurrent builds agree
        return True
    except (OSError, subprocess.SubprocessError):
        if tmp.exists():
            tmp.unlink()
        return False


def _load(name: str) -> Optional[ctypes.CDLL]:
    """The named CDLL, built on first use; None if it cannot be built or
    loaded (the outcome is kept for the life of the process)."""
    if name in _libs:
        return _libs[name]
    with _lock:
        if name in _libs:
            return _libs[name]
        lib = None
        target = _target(name)
        if target.exists() or _build(name, target):
            try:
                lib = ctypes.CDLL(str(target))
            except OSError:
                lib = None
        if lib is not None:
            _declare(name, lib)
        _libs[name] = lib
        return lib


def _declare(name: str, lib: ctypes.CDLL) -> None:
    if name == "fastgeo":
        lib.dedup_grid.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_double,
            ctypes.POINTER(ctypes.c_uint8)]
        lib.dedup_grid.restype = None
        lib.points_in_ring.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
            ctypes.c_int64, ctypes.POINTER(ctypes.c_uint8)]
        lib.points_in_ring.restype = None
    elif name == "fastpack":
        lib.pack_quad_u8.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                     ctypes.c_int64, ctypes.c_void_p]
        lib.pack_quad_u8.restype = ctypes.c_int
    else:
        lib.jpeg_decode_rgb.argtypes = [
            ctypes.c_char_p, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
            ctypes.c_int]
        lib.jpeg_decode_rgb.restype = ctypes.c_int


def load() -> Optional[ctypes.CDLL]:
    """The fastgeo CDLL, or None if unavailable."""
    return _load("fastgeo")


def load_decode() -> Optional[ctypes.CDLL]:
    """The fastdecode CDLL (libjpeg-backed), or None if unavailable
    (no compiler / no libjpeg — callers fall back to PIL)."""
    return _load("fastdecode")


def load_pack() -> Optional[ctypes.CDLL]:
    """The fastpack CDLL (the quad-layout packer), or None if unavailable
    (no compiler — callers take the numpy strided copies)."""
    return _load("fastpack")


def assume_missing(name: str) -> None:
    """Take the named library as unavailable in this process without
    running g++: for worker processes whose parent found that it does not
    build (``fetch/workers.py``)."""
    with _lock:
        _libs.setdefault(name, None)


def native_paths() -> Dict[str, bool]:
    """Which native libraries this process built or loaded
    ({"fastgeo": bool, "fastdecode": bool, "fastpack": bool}); a name not
    yet asked for is loaded now."""
    return {"fastgeo": load() is not None,
            "fastdecode": load_decode() is not None,
            "fastpack": load_pack() is not None}


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def dedup_grid_native(x: np.ndarray, y: np.ndarray, conf: np.ndarray,
                      radius: float) -> Optional[np.ndarray]:
    """Native confidence-greedy dedup; None if the library is unavailable."""
    lib = load()
    if lib is None:
        return None
    x = np.ascontiguousarray(x, dtype=np.float64)
    y = np.ascontiguousarray(y, dtype=np.float64)
    conf = np.ascontiguousarray(conf, dtype=np.float32)
    if not len(x) == len(y) == len(conf):
        raise ValueError(f"dedup_grid_native: lengths {len(x)}, {len(y)}, "
                         f"{len(conf)} differ")
    keep = np.zeros(len(x), dtype=np.uint8)
    lib.dedup_grid(_ptr(x, ctypes.c_double), _ptr(y, ctypes.c_double),
                   _ptr(conf, ctypes.c_float), len(x), float(radius),
                   _ptr(keep, ctypes.c_uint8))
    return keep.astype(bool)


def points_in_rings_native(points: np.ndarray, rings) -> Optional[np.ndarray]:
    """Even-odd containment of points [P,2] in the rings; None if the
    library is unavailable."""
    lib = load()
    if lib is None:
        return None
    points = np.ascontiguousarray(points, dtype=np.float64)
    px = np.ascontiguousarray(points[:, 0])
    py = np.ascontiguousarray(points[:, 1])
    inside = np.zeros(len(points), dtype=np.uint8)
    for ring in rings:
        ring = np.ascontiguousarray(np.asarray(ring, dtype=np.float64))
        rx = np.ascontiguousarray(ring[:, 0])
        ry = np.ascontiguousarray(ring[:, 1])
        lib.points_in_ring(_ptr(px, ctypes.c_double),
                           _ptr(py, ctypes.c_double), len(points),
                           _ptr(rx, ctypes.c_double),
                           _ptr(ry, ctypes.c_double), len(ring),
                           _ptr(inside, ctypes.c_uint8))
    return inside.astype(bool)


def decode_jpeg_native(data: bytes,
                       scale_denom: int = 1) -> Optional[np.ndarray]:
    """JPEG bytes → uint8 [H, W, 3] RGB via libjpeg, decoded at
    1/scale_denom resolution. None if the native library is unavailable or
    the stream is not decodable (caller falls back to PIL)."""
    lib = load_decode()
    if lib is None:
        return None
    w = ctypes.c_int()
    h = ctypes.c_int()
    rc = lib.jpeg_decode_rgb(data, len(data), None, 0,
                             ctypes.byref(w), ctypes.byref(h), scale_denom)
    if rc != 0:
        return None
    out = np.empty((h.value, w.value, 3), dtype=np.uint8)
    rc = lib.jpeg_decode_rgb(data, len(data),
                             out.ctypes.data_as(ctypes.c_void_p), out.nbytes,
                             ctypes.byref(w), ctypes.byref(h), scale_denom)
    if rc != 0:
        return None
    return out


def pack_quad_native(px: np.ndarray, out: np.ndarray) -> bool:
    """Quad-layout pack [H,W,3] u8 → [H/4,W/4,48] u8 by the native
    12-byte-run copier (the interpreter lock is released for the call, so
    it runs in parallel across ingest threads). False if the library is
    unavailable or the arrays do not qualify: the caller falls back to the
    numpy strided copy."""
    lib = load_pack()
    if (lib is None or px.dtype != np.uint8 or out.dtype != np.uint8
            or px.ndim != 3 or px.shape[2] != 3 or (px.shape[0] % 4)
            or (px.shape[1] % 4)
            or out.shape != (px.shape[0] // 4, px.shape[1] // 4, 48)
            or not px.flags.c_contiguous or not out.flags.c_contiguous):
        return False
    rc = lib.pack_quad_u8(px.ctypes.data_as(ctypes.c_void_p),
                          px.shape[0], px.shape[1],
                          out.ctypes.data_as(ctypes.c_void_p))
    return rc == 0
