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
SOURCES = ("zbuffer_keys.cu", "rasterize.cu", "aspp.cu", "conv_epilogue.cu",
           "conv_epilogue_train.cu")
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
CFLAGS = ARCH + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
_SIGNATURES = {
    "pmf_zbuffer_keys": [_P, _P, _P, _I, _I, _I, _I, _P],
    "pmf_rasterize_zbuffer": [_P, _P, _P, _P, _P, _P, _P, _P,
                              _I, _I, _I, _I, _I, _F, _I, _P],
    "pmf_aspp_branches": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "pmf_conv_epilogue": [_P, _P, _P, _P, _P, _L, _I, _I, _I, _I, _I, _P],
    "pmf_bn_train_stats": [_P, _P, _P, _P, _P, _P, _P, _P, _L, _I, _I, _F, _F, _I, _I, _P],
    "pmf_bn_train_apply": [_P, _P, _P, _P, _P, _L, _I, _I, _I, _I, _I, _I, _P],
    "pmf_bn_train_grad_sums": [_P, _L, _P, _P, _P, _P, _P, _P, _P, _L, _I, _I, _I, _I, _I, _I,
                               _P],
    "pmf_bn_train_grad_apply": [_P, _L, _P, _P, _P, _P, _P, _L, _I, _I, _I, _I, _I, _P],
}


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return found


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CFLAGS).encode())
    for path in sorted(CSRC.iterdir()):  # the sources and the headers they include
        h.update(path.name.encode())
        h.update(path.read_bytes())
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


@functools.lru_cache(maxsize=8)
def sms(device: torch.device) -> int:
    """The card's multiprocessors."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def check(t: torch.Tensor, name: str, dtype: torch.dtype, shape: tuple,
          device: torch.device) -> None:
    """Reject what a kernel does not take, before its pointer is passed."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if t.shape != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def launch(entry: str, device: torch.device, *args) -> None:
    """Call the C entry point `entry` with `args`, then `device`'s index and
    its current stream, and raise if it returns a CUDA error. The entry
    makes the device current for its launches (csrc/device_guard.cuh). The
    stream goes as its raw handle, which builds no Python Stream object: K1
    is short enough on the device that the host's per-call work sets its
    time."""
    index = device.index
    rc = getattr(load(), entry)(*args, index, torch._C._cuda_getCurrentRawStream(index))
    if rc:
        raise RuntimeError(f"{entry} failed: CUDA error {rc}")
