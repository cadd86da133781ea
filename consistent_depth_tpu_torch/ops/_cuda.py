"""Build and load the port's hand-written CUDA kernels.

The sources in ``consistent_depth_tpu_torch/csrc/*.cu`` are compiled with
``nvcc`` for ``sm_90a``, one ``nvcc`` process per source, all started
together, and linked into one shared library with a plain C interface,
``build/cuda/libcdtt_<hash>.so`` at the root of the checkout, at first use.
The hash covers the sources and the compiler flags, so editing a source
rebuilds it. The library is loaded with ``ctypes``; every pointer and the
stream cross as ``c_void_p``.

There is no fallback: a missing ``nvcc`` or a failed build raises. Callers
reach this module only for tensors on a CUDA device.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

_PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG_DIR / "csrc"
BUILD_DIR = _PKG_DIR.parent / "build" / "cuda"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

_lib: Optional[ctypes.CDLL] = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise RuntimeError(
        "nvcc not found (looked on PATH and in $CUDA_HOME/bin); the port's "
        "CUDA kernels are built from source at first use")


def _sources():
    return sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS + ("-shared",)).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libcdtt_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels if the library for the current sources is
    missing; return its path. Each source compiles in its own ``nvcc``
    process, all at once, then one ``nvcc -shared`` links them. Processes
    building at the same time each write private files and rename the
    library into place."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    nvcc = _nvcc()
    jobs = []
    for src in (s for s in _sources() if s.suffix == ".cu"):
        obj = BUILD_DIR / f"{tag}.{src.stem}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        jobs.append((obj, cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    tmp = BUILD_DIR / f"{tag}.so.tmp"
    try:
        failed = []
        for _, cmd, proc in jobs:
            stdout, stderr = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"{' '.join(cmd)}\n{stdout}\n{stderr}")
        if not failed:
            cmd = [nvcc, "-shared", "-o", str(tmp),
                   *[str(obj) for obj, _, _ in jobs]]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                failed.append(f"{' '.join(cmd)}\n{proc.stdout}\n"
                              f"{proc.stderr}")
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        os.replace(tmp, out)
    finally:
        tmp.unlink(missing_ok=True)
        for obj, _, _ in jobs:
            obj.unlink(missing_ok=True)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library (built first if needed)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        lib.same_conv_forward.argtypes = (
            [p, p, p, p] + [i32] * 7 + [i64] * 8 + [p])
        lib.same_conv_forward.restype = i32
        lib.correlation_forward.argtypes = (
            [p, p, p] + [i32] * 6 + [i64] * 8 + [p])
        lib.correlation_forward.restype = i32
        lib.same_conv_error_string.argtypes = [i32]
        lib.same_conv_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C entry returned a CUDA error (any entry's code reads
    through ``same_conv_error_string``, which is ``cudaGetErrorString``)."""
    if err != 0:
        msg = lib.same_conv_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
