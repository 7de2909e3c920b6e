"""ctypes binding to the native scan reader `native/libpmfloader.so`
(counterpart of `pmf_tpu/data/native.py`, the same C ABI).

`native/loader.cpp` reads a KITTI-format scan, maps its labels through a
LUT and pads it to the point bucket, and decodes the PNG or JPEG image
straight onto the padded float canvas, in calls that release the GIL, so a
thread pool of readers runs them side by side. Where the library does not
load (not built, or a shared library it links is missing), `available()` is
False and the readers take the numpy path.
"""
from __future__ import annotations

import ctypes
import os

import numpy as np

LIB_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "native", "libpmfloader.so")

_state: dict = {}


def load_library():
    """The library with its signatures declared, or None where it does not
    load; tried once a process."""
    if "lib" in _state:
        return _state["lib"]
    lib = None
    if os.path.isfile(LIB_PATH):
        try:
            lib = ctypes.CDLL(LIB_PATH)
        except OSError as err:
            _state["error"] = str(err)
    if lib is not None:
        _declare(lib)
    _state["lib"] = lib
    return lib


def load_error() -> str | None:
    """Why the library did not load, if it did not."""
    load_library()
    return _state.get("error")


def _declare(lib) -> None:
    i64, i32p, f32p, u8p = (ctypes.c_int64, ctypes.POINTER(ctypes.c_int32),
                            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_uint8))
    lib.read_scan.restype = i64
    lib.read_scan.argtypes = [ctypes.c_char_p, ctypes.c_char_p, i32p, i64, i64, i64,
                              f32p, i32p, u8p]
    lib.read_scan_batch.restype = ctypes.c_int
    lib.read_scan_batch.argtypes = [ctypes.POINTER(ctypes.c_char_p),
                                    ctypes.POINTER(ctypes.c_char_p), i64, i32p, i64, i64, i64,
                                    f32p, i32p, u8p, ctypes.POINTER(ctypes.c_int64)]
    if hasattr(lib, "decode_png"):
        # decode_image sniffs PNG or JPEG; builds before JPEG export decode_png only
        decoder = getattr(lib, "decode_image", lib.decode_png)
        decoder.restype = ctypes.c_int
        decoder.argtypes = [ctypes.c_char_p, f32p, i64, i64, i32p, i32p]
        lib._decode_image = decoder
        lib.read_scan_full.restype = i64
        lib.read_scan_full.argtypes = [ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p,
                                       i32p, i64, i64, i64, f32p, i32p, u8p, f32p, i64, i64,
                                       i32p, i32p]


def available() -> bool:
    return load_library() is not None


def image_available() -> bool:
    """True when the library decodes images (PNG and JPEG)."""
    lib = load_library()
    return lib is not None and hasattr(lib, "_decode_image")


def _ptr(arr: np.ndarray, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def _lib(need_image: bool = False):
    lib = load_library()
    if lib is None or (need_image and not hasattr(lib, "_decode_image")):
        raise RuntimeError(f"native reader not available ({load_error() or LIB_PATH}); "
                           "build it with `make -C native`")
    return lib


def _lut(label_lut) -> np.ndarray:
    return np.ascontiguousarray(label_lut, np.int32)


def read_scan(pcd_path: str, label_path: str | None, label_lut: np.ndarray, n_max: int,
              point_dim: int = 4):
    """One scan padded to n_max points: (points [n_max, point_dim] f32,
    labels [n_max] int32 through the LUT, valid [n_max] bool, n read)."""
    lib = _lib()
    lut = _lut(label_lut)
    points = np.empty((n_max, point_dim), np.float32)
    labels = np.empty((n_max,), np.int32)
    valid = np.empty((n_max,), np.uint8)
    n = lib.read_scan(pcd_path.encode(), (label_path or "").encode(),
                      _ptr(lut, ctypes.c_int32), lut.size, n_max, point_dim,
                      _ptr(points, ctypes.c_float), _ptr(labels, ctypes.c_int32),
                      _ptr(valid, ctypes.c_uint8))
    if n < 0:
        raise IOError(f"native read failed: {pcd_path}")
    return points, labels, valid.astype(bool), int(n)


def read_scan_batch(pcd_paths, label_paths, label_lut: np.ndarray, n_max: int,
                    point_dim: int = 4):
    """A batch of scans read in parallel (one native thread a scan):
    (points [B, n_max, point_dim], labels [B, n_max], valid [B, n_max] bool,
    counts [B])."""
    lib = _lib()
    B = len(pcd_paths)
    lut = _lut(label_lut)
    points = np.empty((B, n_max, point_dim), np.float32)
    labels = np.empty((B, n_max), np.int32)
    valid = np.empty((B, n_max), np.uint8)
    counts = np.empty((B,), np.int64)
    c_pcd = (ctypes.c_char_p * B)(*[p.encode() for p in pcd_paths])
    c_lbl = (ctypes.c_char_p * B)(*[(p or "").encode()
                                    for p in (label_paths or [None] * B)])
    failures = lib.read_scan_batch(c_pcd, c_lbl, B, _ptr(lut, ctypes.c_int32), lut.size, n_max,
                                   point_dim, _ptr(points, ctypes.c_float),
                                   _ptr(labels, ctypes.c_int32), _ptr(valid, ctypes.c_uint8),
                                   _ptr(counts, ctypes.c_int64))
    if failures:
        bad = [p for p, c in zip(pcd_paths, counts) if c < 0]
        raise IOError(f"native batch read failed for {failures} scans: {bad}")
    return points, labels, valid.astype(bool), counts


def decode_image(path: str, canvas_h: int, canvas_w: int):
    """A PNG (8-bit gray, RGB or RGBA, not interlaced) or JPEG decoded onto
    a zero [canvas_h, canvas_w, 3] float32 canvas, top-left, /255 (as
    `pad_image` places it): (canvas, img_h, img_w). Raises IOError on other
    files."""
    lib = _lib(need_image=True)
    canvas = np.empty((canvas_h, canvas_w, 3), np.float32)
    h, w = ctypes.c_int32(), ctypes.c_int32()
    rc = lib._decode_image(path.encode(), _ptr(canvas, ctypes.c_float), canvas_h, canvas_w,
                           ctypes.byref(h), ctypes.byref(w))
    if rc != 0:
        raise IOError(f"native image decode failed ({rc}): {path}")
    return canvas, np.int32(h.value), np.int32(w.value)


def read_scan_full(pcd_path: str, label_path: str | None, image_path: str,
                   label_lut: np.ndarray, n_max: int, canvas_h: int, canvas_w: int,
                   point_dim: int = 4):
    """Scan, labels and image of one sample in one call: (points, labels,
    valid, canvas, img_h, img_w, n)."""
    lib = _lib(need_image=True)
    lut = _lut(label_lut)
    points = np.empty((n_max, point_dim), np.float32)
    labels = np.empty((n_max,), np.int32)
    valid = np.empty((n_max,), np.uint8)
    canvas = np.empty((canvas_h, canvas_w, 3), np.float32)
    h, w = ctypes.c_int32(), ctypes.c_int32()
    n = lib.read_scan_full(pcd_path.encode(), (label_path or "").encode(), image_path.encode(),
                           _ptr(lut, ctypes.c_int32), lut.size, n_max, point_dim,
                           _ptr(points, ctypes.c_float), _ptr(labels, ctypes.c_int32),
                           _ptr(valid, ctypes.c_uint8), _ptr(canvas, ctypes.c_float),
                           canvas_h, canvas_w, ctypes.byref(h), ctypes.byref(w))
    if n < 0:
        raise IOError(f"native full-scan read failed ({n}): {pcd_path}")
    return (points, labels, valid.astype(bool), canvas, np.int32(h.value),
            np.int32(w.value), int(n))
