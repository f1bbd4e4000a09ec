"""Build and load the port's CUDA kernels.

The sources under ``mpgan_tpu_torch/csrc/`` are compiled at first use with
``nvcc`` into a shared library with a plain C interface, and loaded through
``ctypes``. The library lands in ``build/torch_ext/<hash>/`` at the root of
the checkout, where ``<hash>`` covers the sources and the compiler flags, so a
changed source builds anew and an unchanged one is reused. Nothing here falls
back: a missing ``nvcc`` or a failed compile raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import threading
import time

_PKG = pathlib.Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG.parent / "build" / "torch_ext"
SOURCES = ("edge_aggregate.cu",)
NVCC_FLAGS = (
    "-O3", "-std=c++17", "-gencode", "arch=compute_90a,code=sm_90a",
    "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
)
_LIB_NAME = "libmpgan_kernels.so"

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
build_info: dict = {}


def find_nvcc() -> str:
    """``nvcc`` from PATH, else from ``$CUDA_HOME/bin`` or the default toolkit location."""
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = pathlib.Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    if (cuda_home / "bin" / "nvcc").is_file():
        return str(cuda_home / "bin" / "nvcc")
    raise RuntimeError(
        "nvcc not found on PATH or in $CUDA_HOME/bin (default /usr/local/cuda); "
        "the CUDA kernels cannot be built"
    )


def _source_hash() -> str:
    h = hashlib.sha256()
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build() -> pathlib.Path:
    """Compile the kernels unless a library for these sources exists; returns its path."""
    out_dir = BUILD_ROOT / _source_hash()
    lib_path = out_dir / _LIB_NAME
    if lib_path.is_file():
        build_info.update(path=str(lib_path), seconds=0.0, cached=True)
        return lib_path
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    # compile to a private name, then rename: concurrent builders never see a partial file
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, *(str(CSRC / s) for s in SOURCES)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}"
        )
    os.replace(tmp, lib_path)
    (out_dir / "build.log").write_text(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    build_info.update(
        path=str(lib_path), seconds=seconds, cached=False, log=proc.stdout + proc.stderr
    )
    return lib_path


def _declare(lib: ctypes.CDLL) -> None:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    parr, iarr = ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int)
    lib.mpgan_edge_aggregate.argtypes = [
        p, p, p, p, i, i, i, i, parr, parr, iarr, f, i, p,
    ]
    lib.mpgan_edge_aggregate.restype = i
    lib.mpgan_edge_aggregate_fn.argtypes = [
        p, p, p, p, p, i, i, i, i, i, parr, parr, iarr, i, parr, p, parr, iarr, f, i, f, i, p,
    ]
    lib.mpgan_edge_aggregate_fn.restype = i
    lib.mpgan_cuda_error_string.argtypes = [i]
    lib.mpgan_cuda_error_string.restype = ctypes.c_char_p


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            _declare(lib)
            _lib = lib
        return _lib


def check(code: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error code."""
    if code != 0:
        msg = library().mpgan_cuda_error_string(code).decode()
        raise RuntimeError(f"{what} failed: CUDA error {code} ({msg})")
