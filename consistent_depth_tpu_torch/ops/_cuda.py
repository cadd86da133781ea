"""Build and load the port's hand-written CUDA kernels.

The sources in ``consistent_depth_tpu_torch/csrc/*.cu`` (sharing the
headers ``csrc/*.cuh``) are compiled with
``nvcc`` for ``sm_90a``, one ``nvcc`` process per source, all started
together, and linked into one shared library with a plain C interface,
``build/cuda/libcdtt_<hash>.so`` at the root of the checkout, at first use.
The hash covers the sources and the compiler flags, so editing a source
rebuilds it. The library is loaded with ``ctypes``; every pointer and the
stream cross as ``c_void_p``. It links the CUDA runtime only: the one
driver call, ``cuTensorMapEncodeTiled`` (the TMA tensor maps of the wgmma
sources, encoded in ``csrc/same_conv_wgmma.cuh``), is looked up at run time
through ``cudaGetDriverEntryPoint`` (``csrc/linear_wgmma_tf32.cu`` and
``csrc/attention_wgmma_tf32.cu`` include the same header).

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

# the routed conv entries' arguments (same_conv_<route>_forward and
# _grad_input): the forward's x, w, bias, out, the grad-input's ct, w, dx;
# dtype, N, H, W, Ci, Co, K; the (n, h, w, c) element strides of x or ct and
# the (r, c, i, o) strides of w; tile_h, split; the workspace, the stream
ROUTED_CONV_ROUTES = ("tc", "tf32", "wgmma", "wgmma_tf32")
ROUTED_FORWARD_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                           + [ctypes.c_int64] * 8 + [ctypes.c_int] * 2
                           + [ctypes.c_void_p] * 2)
ROUTED_GRAD_INPUT_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 7
                              + [ctypes.c_int64] * 8 + [ctypes.c_int] * 2
                              + [ctypes.c_void_p] * 2)
# same_conv_tf32_split_weight's arguments: w, planes, Ci, Co, K, the (r, c,
# i, o) element strides of w, grad, the stream
SPLIT_WEIGHT_ARGTYPES = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 3
                         + [ctypes.c_int64] * 4 + [ctypes.c_int]
                         + [ctypes.c_void_p])
# correlation_banded_forward's arguments: f1, f2, out, B, H, W, C, r, the
# (n, h, w) element strides of f1 and of f2, the stream
CORRELATION_BANDED_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 5
                               + [ctypes.c_int64] * 6 + [ctypes.c_void_p])
# grouped_wgrad's arguments: x, dy, dw, the workspace; N, H, W, C, groups,
# stride, splits; the (n, h, w) element strides of x and of dy and the (o,
# i, r, s) strides of dw; the stream
GROUPED_WGRAD_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                          + [ctypes.c_int64] * 10 + [ctypes.c_void_p])
# linear_wgmma_tf32's arguments: a, its row stride, a_mn; the planes, their
# row stride; bias, out, out's (row, column) element strides; R, C, Kr,
# split, blocks; the workspace, the stream
LINEAR_ARGTYPES = ([ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                    ctypes.c_void_p, ctypes.c_int64]
                   + [ctypes.c_void_p] * 2 + [ctypes.c_int64] * 2
                   + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 2)
# linear_tf32_split's arguments: src, planes, rows, cols, src's (row,
# column) element strides, the planes' row length, the stream
LINEAR_SPLIT_ARGTYPES = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 2
                         + [ctypes.c_int64] * 3 + [ctypes.c_void_p])
# attention_tf32_split's arguments: src, its (b, h, l) element strides; B,
# H, L, the head width d; the K-major and the transposed planes (either
# NULL), lp, permute; the stream
ATTENTION_SPLIT_ARGTYPES = ([ctypes.c_void_p] + [ctypes.c_int64] * 3
                            + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2
                            + [ctypes.c_int] * 2 + [ctypes.c_void_p])
# attention_wgmma_tf32_forward's arguments: q, its (b, h, l) element
# strides; K's planes, V's transposed planes, out, out's (b, h, l) strides;
# lse; B, H, L, d, lp; the stream
ATTENTION_FORWARD_ARGTYPES = ([ctypes.c_void_p] + [ctypes.c_int64] * 3
                              + [ctypes.c_void_p] * 3 + [ctypes.c_int64] * 3
                              + [ctypes.c_void_p] + [ctypes.c_int] * 5
                              + [ctypes.c_void_p])
# attention_wgmma_tf32_backward's arguments: q and dO, each with its (b, h,
# l) element strides; K's and V's planes, K's transposed planes, lse, dsum,
# dq, dk, dv; B, H, L, d, lp; the stream
ATTENTION_BACKWARD_ARGTYPES = ([ctypes.c_void_p] + [ctypes.c_int64] * 3
                               + [ctypes.c_void_p] + [ctypes.c_int64] * 3
                               + [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5
                               + [ctypes.c_void_p])
# attention_rowdot's arguments: o and dO, each with its (b, h, l) element
# strides; dsum; B, H, L, d; the stream
ATTENTION_ROWDOT_ARGTYPES = ([ctypes.c_void_p] + [ctypes.c_int64] * 3
                             + [ctypes.c_void_p] + [ctypes.c_int64] * 3
                             + [ctypes.c_void_p] + [ctypes.c_int] * 4
                             + [ctypes.c_void_p])

ATTENTION_ENTRIES = {
    "attention_tf32_split": ATTENTION_SPLIT_ARGTYPES,
    "attention_wgmma_tf32_forward": ATTENTION_FORWARD_ARGTYPES,
    "attention_wgmma_tf32_backward": ATTENTION_BACKWARD_ARGTYPES,
    "attention_rowdot": ATTENTION_ROWDOT_ARGTYPES,
}


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
        i32 = ctypes.c_int
        for route in ROUTED_CONV_ROUTES:
            fwd = getattr(lib, f"same_conv_{route}_forward")
            fwd.argtypes = ROUTED_FORWARD_ARGTYPES
            fwd.restype = i32
            gx = getattr(lib, f"same_conv_{route}_grad_input")
            gx.argtypes = ROUTED_GRAD_INPUT_ARGTYPES
            gx.restype = i32
        lib.same_conv_tf32_split_weight.argtypes = SPLIT_WEIGHT_ARGTYPES
        lib.same_conv_tf32_split_weight.restype = i32
        lib.correlation_banded_forward.argtypes = CORRELATION_BANDED_ARGTYPES
        lib.correlation_banded_forward.restype = i32
        lib.grouped_wgrad.argtypes = GROUPED_WGRAD_ARGTYPES
        lib.grouped_wgrad.restype = i32
        lib.linear_wgmma_tf32.argtypes = LINEAR_ARGTYPES
        lib.linear_wgmma_tf32.restype = i32
        lib.linear_tf32_split.argtypes = LINEAR_SPLIT_ARGTYPES
        lib.linear_tf32_split.restype = i32
        for name, argtypes in ATTENTION_ENTRIES.items():
            getattr(lib, name).argtypes = argtypes
            getattr(lib, name).restype = i32
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
