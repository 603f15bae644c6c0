"""Build the port's CUDA kernels and load them with ctypes.

Every ``repro_torch/csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a``
(one process per source, all started together), linked into one shared
library with a plain C interface, and loaded with :mod:`ctypes`.  The
library lands in ``build/repro_torch/`` at the repository root, named by
a hash of the sources and flags, so it is built at first use and reused
until a source changes.  A missing ``nvcc`` or a failed build raises
with the compiler's output; nothing falls back to the plain versions.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile

PACKAGE = pathlib.Path(__file__).resolve().parents[1]
CSRC = PACKAGE / "csrc"
BUILD_DIR = PACKAGE.parents[1] / "build" / "repro_torch"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_int64

#: C entry point -> argtypes (every pointer and the stream as c_void_p)
SIGNATURES = {
    "exit_gate_plan": [_I, _I, _I, _P],
    "exit_gate_launch": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    "difficulty_launch": [_P, _P, _I, _I, _I, _I, _F, _F, _F, _F, _F, _F,
                          _P],
    "exit_head_plan": [_I, _I, _I, _I, _P],
    "exit_head_launch": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                         _I, _F, _P],
    "paged_gather_launch": [_P, _P, _P, _I, _I, _L, _P],
}


def sources() -> list[pathlib.Path]:
    return sorted(CSRC.glob("*.cu"))


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found on PATH or under /usr/local/cuda; "
                           "the CUDA kernels cannot be built")
    return path


def library_path() -> pathlib.Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"librepro_torch_{h.hexdigest()[:16]}.so"


def _run_all(cmds: list[list[str]]) -> None:
    """Run the commands in parallel; raise with stderr if any fails."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for c in cmds]
    failed = []
    for cmd, p in zip(cmds, procs):
        out, err = p.communicate()
        if p.returncode:
            failed.append(f"$ {' '.join(cmd)}\n{out}{err}")
    if failed:
        raise RuntimeError("nvcc build failed:\n" + "\n".join(failed))


def build() -> pathlib.Path:
    """Compile and link the library if it is not built yet; returns its
    path."""
    lib = library_path()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cc = nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [pathlib.Path(tmp) / (s.stem + ".o") for s in sources()]
        _run_all([[cc, *NVCC_FLAGS, "-c", str(s), "-o", str(o)]
                  for s, o in zip(sources(), objs)])
        staged = pathlib.Path(tmp) / lib.name
        _run_all([[cc, *NVCC_FLAGS, "-shared", *map(str, objs),
                   "-o", str(staged)]])
        os.replace(staged, lib)
    return lib


@functools.cache
def load_library() -> ctypes.CDLL:
    """The built library with every entry point's argtypes declared."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib
