"""Build and load the port's hand-written CUDA kernels.

The sources in `pmf_tpu_torch/csrc/` have a plain C interface. At first use
each source is compiled by its own `nvcc` (all started together) for
`sm_90a`, the objects are linked into one shared library under `build/` at
the repository root, and the library is loaded with `ctypes`. The library's
name carries a hash of the sources and flags, so an edited source is rebuilt
and an unchanged one is reused. The compiler's register and spill report
(`-Xptxas -v`) is kept beside the library in `build/<name>.log`.

Nothing here runs at import: the CPU tests import every module, and this
machine may have no `nvcc`.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
SOURCES = ("zbuffer_keys.cu", "rasterize.cu")
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
CFLAGS = ARCH + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "pmf_zbuffer_keys": [_P, _P, _P, _I, _I, _I, _P],
    "pmf_rasterize_zbuffer": [_P, _P, _P, _P, _P, _P, _P, _P,
                              _I, _I, _I, _I, _I, ctypes.c_float, _P],
}


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return found


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CFLAGS).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return BUILD_DIR / f"libpmf_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels unless a library of the same sources exists."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp) / f"{Path(s).stem}.o" for s in SOURCES]
        procs = [subprocess.Popen([nvcc, *CFLAGS, "-c", str(CSRC / s), "-o", str(o)],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                  text=True)
                 for s, o in zip(SOURCES, objs)]
        logs = [p.communicate()[0] for p in procs]
        for s, p, log in zip(SOURCES, procs, logs):
            if p.returncode:
                raise RuntimeError(f"nvcc failed on {s}:\n{log}")
        tmp_so = Path(tmp) / so.name
        link = subprocess.run([nvcc, *ARCH, "-shared", *map(str, objs),
                               "-o", str(tmp_so)],
                              capture_output=True, text=True)
        if link.returncode:
            raise RuntimeError(f"linking the kernels failed:\n{link.stderr}")
        so.with_suffix(".log").write_text("".join(logs))
        os.replace(tmp_so, so)  # atomic: a concurrent build sees all or none
    return so


@functools.cache
def load() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check(t: torch.Tensor, name: str, dtype: torch.dtype, shape: tuple,
          device: torch.device) -> None:
    """Reject what a kernel does not take, before its pointer is passed."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def raise_on_error(rc: int, kernel: str) -> None:
    if rc:
        raise RuntimeError(f"{kernel} failed to launch: CUDA error {rc}")
