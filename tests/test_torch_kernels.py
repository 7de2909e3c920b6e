"""The kernels' build and call layer (`pmf_tpu_torch/ops/kernels.py`) on the
CPU: every `extern "C"` entry of `csrc/` against its ctypes signature, the
checks before a pointer is passed, the library's name by the sources'
hash, the build's reuse of a library it finds, the missing toolkit, and
`launch` against a stand-in library. Nothing here compiles or needs a card.
"""
import ctypes
import os
import re
import shutil

import pytest
import torch

from pmf_tpu_torch.ops import kernels
from tests.torch_threads import one_torch_thread  # noqa: F401

_ENTRY = re.compile(r'extern\s+"C"\s+int\s+(pmf_\w+)\s*\(([^)]*)\)')


def _kind(param: str):
    """The ctypes type a C parameter passes as: any pointer as a void
    pointer, else by its scalar type."""
    if "*" in param:
        return ctypes.c_void_p
    words = param.split()[:-1]
    return {("int",): ctypes.c_int, ("long", "long"): ctypes.c_longlong,
            ("float",): ctypes.c_float}[tuple(words)]


def _entries(names) -> dict:
    """{entry: (source, [ctypes type of each parameter])} of the csrc files
    `names`."""
    found = {}
    for name in names:
        for entry, params in _ENTRY.findall((kernels.CSRC / name).read_text()):
            assert entry not in found, f"{entry} is declared twice"
            found[entry] = (name, [_kind(p) for p in params.split(",")])
    return found


@pytest.mark.parametrize("entry", sorted(kernels._SIGNATURES))
def test_signature_matches_its_c_declaration(entry):
    """Each entry `load` declares is an `extern "C" int` of a file of
    SOURCES with the same parameters: the count, and pointer, int, long
    long or float at each place."""
    declared = _entries(kernels.SOURCES)
    assert entry in declared, f"{entry} is in no file of SOURCES"
    assert declared[entry][1] == kernels._SIGNATURES[entry]


def test_every_c_entry_is_built_and_declared():
    """Every .cu file of csrc/ is in SOURCES, and each of its entries has a
    signature."""
    sources = sorted(p.name for p in kernels.CSRC.glob("*.cu"))
    assert sorted(kernels.SOURCES) == sources
    assert sorted(_entries(sources)) == sorted(kernels._SIGNATURES)


GOOD = dict(dtype=torch.int32, shape=(2, 3), device=torch.device("cpu"))


@pytest.mark.parametrize("tensor, message", [
    (torch.zeros(2, 3, dtype=torch.int32, device="meta"), "is on meta"),
    (torch.zeros(2, 3, dtype=torch.int64), "has dtype torch.int64"),
    (torch.zeros(3, 2, dtype=torch.int32), "has shape (3, 2)"),
    (torch.zeros(3, 2, dtype=torch.int32).t(), "must be contiguous"),
    (torch.zeros(2, 3, dtype=torch.int32), None),
], ids=["device", "dtype", "shape", "contiguity", "match"])
def test_check(tensor, message):
    """`check` names the tensor and what is wrong, and passes a match."""
    if message is None:
        kernels.check(tensor, "pix", **GOOD)
        return
    with pytest.raises(ValueError, match=re.escape(f"pix {message}")):
        kernels.check(tensor, "pix", **GOOD)


@pytest.fixture
def csrc_copy(tmp_path, monkeypatch):
    """kernels reading a copy of csrc/ and building into tmp_path/build."""
    copy = tmp_path / "csrc"
    shutil.copytree(kernels.CSRC, copy)
    monkeypatch.setattr(kernels, "CSRC", copy)
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path / "build")
    return copy


def _flip_last_byte(path):
    data = bytearray(path.read_bytes())
    data[-1] ^= 1
    path.write_bytes(bytes(data))


@pytest.mark.parametrize("edit", ["none", "cu", "cuh", "cflags"])
def test_library_path_follows_sources_and_flags(csrc_copy, monkeypatch, edit):
    """The library's name changes with a byte of a source or a header or
    with the flags, and with nothing else."""
    before = kernels.library_path()
    assert before.parent == kernels.BUILD_DIR and before.name.startswith("libpmf_kernels_")
    if edit == "cu":
        _flip_last_byte(csrc_copy / kernels.SOURCES[0])
    elif edit == "cuh":
        _flip_last_byte(next(csrc_copy.glob("*.cuh")))
    elif edit == "cflags":
        monkeypatch.setattr(kernels, "CFLAGS", kernels.CFLAGS + ["-lineinfo"])
    assert (kernels.library_path() == before) == (edit == "none")


def test_build_reuses_an_existing_library(csrc_copy, monkeypatch):
    """A library of these sources and flags is returned as it is: no nvcc
    is looked for or run."""
    def no_nvcc(*args, **kwargs):
        raise AssertionError("build ran the compiler")

    monkeypatch.setattr(kernels, "_nvcc", no_nvcc)
    monkeypatch.setattr(kernels.subprocess, "Popen", no_nvcc)
    monkeypatch.setattr(kernels.subprocess, "run", no_nvcc)
    so = kernels.library_path()
    so.parent.mkdir(parents=True)
    so.write_bytes(b"built")
    assert kernels.build() == so and so.read_bytes() == b"built"


def test_nvcc_missing_raises(monkeypatch):
    """Without nvcc on the PATH or under /usr/local/cuda the build stops
    with a RuntimeError that says so."""
    exists = os.path.exists
    monkeypatch.setattr(kernels.shutil, "which", lambda name: None)
    monkeypatch.setattr(kernels.os.path, "exists",
                        lambda p: False if str(p).endswith("bin/nvcc") else exists(p))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kernels._nvcc()


class _Library:
    """A stand-in for the loaded library: each entry records its arguments
    and returns `rc`."""

    def __init__(self, rc: int):
        self.rc, self.calls = rc, []

    def __getattr__(self, entry):
        def call(*args):
            self.calls.append((entry, args))
            return self.rc
        return call


@pytest.fixture
def raw_stream(monkeypatch):
    """torch's current raw stream of a device index, as the handle 1000 +
    index (this torch build may have no CUDA binding to patch)."""
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream", lambda index: 1000 + index,
                        raising=False)


def test_launch_passes_the_device_and_stream_last(monkeypatch, raw_stream):
    lib = _Library(0)
    monkeypatch.setattr(kernels, "load", lambda: lib)
    kernels.launch("pmf_zbuffer_keys", torch.device("cuda", 3), 11, 22, 33)
    assert lib.calls == [("pmf_zbuffer_keys", (11, 22, 33, 3, 1003))]


def test_launch_raises_on_an_error_code(monkeypatch, raw_stream):
    lib = _Library(700)
    monkeypatch.setattr(kernels, "load", lambda: lib)
    with pytest.raises(RuntimeError, match="pmf_conv_epilogue failed: CUDA error 700"):
        kernels.launch("pmf_conv_epilogue", torch.device("cuda", 0), 1, 2)
    assert len(lib.calls) == 1
