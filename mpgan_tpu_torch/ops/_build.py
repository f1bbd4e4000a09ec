"""Build and load the port's CUDA kernels.

The sources under ``mpgan_tpu_torch/csrc/`` are compiled at first use with
``nvcc``, one process per source started together, and linked into a shared
library with a plain C interface, loaded through ``ctypes``. The library lands
in ``build/torch_ext/<hash>/`` at the root of the checkout, where ``<hash>``
covers the sources and the compiler flags, so a changed source builds anew and
an unchanged one is reused. Nothing here falls back: a missing ``nvcc`` or a
failed compile raises.
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
SOURCES = ("edge_aggregate.cu", "edge_aggregate_bwd.cu", "edge_aggregate_bf16.cu",
           "edge_aggregate_bwd_bf16.cu", "knn_fused.cu", "knn_edge_bwd.cu", "knn_search.cu",
           "knn_edge_aggregate.cu", "knn_fused_bf16.cu", "knn_edge_bwd_bf16.cu", "gapt_fused.cu",
           "threefry.cu")
HEADERS = ("edge_common.cuh", "edge_products.cuh", "edge_products_bf16.cuh",
           "edge_fwd_common.cuh", "edge_fwd_bf16_tiles.cuh",
           "edge_bwd_common.cuh",
           "edge_bwd_bf16.cuh", "edge_bwd_tf32x3.cuh", "edge_aggregate.cuh",
           "edge_aggregate_bwd.cuh",
           "knn_stages.cuh", "knn_edge_bwd.cuh")
NVCC_FLAGS = (
    "-O3", "-std=c++17", "-gencode", "arch=compute_90a,code=sm_90a",
    "-Xptxas", "-v", "-Xcompiler", "-fPIC",
)
_LIB_NAME = "libmpgan_kernels.so"

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_lib_defines: tuple = ()
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


def _source_hash(flags) -> str:
    h = hashlib.sha256()
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(flags).encode())
    return h.hexdigest()[:16]


def build(defines=()) -> pathlib.Path:
    """Compile the kernels unless a library for these sources exists; returns its
    path. ``defines`` are preprocessor names (``-D``) that select a build of their own."""
    flags = NVCC_FLAGS + tuple(f"-D{d}" for d in defines)
    out_dir = BUILD_ROOT / _source_hash(flags)
    lib_path = out_dir / _LIB_NAME
    if lib_path.is_file():
        build_info.update(path=str(lib_path), seconds=0.0, cached=True)
        return lib_path
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    # compile to private names, then rename: a concurrent build never sees a partial file
    tmp_dir = pathlib.Path(tempfile.mkdtemp(dir=out_dir))
    t0 = time.perf_counter()
    try:
        objs = [tmp_dir / (pathlib.Path(src).stem + ".o") for src in SOURCES]
        cmds = [[nvcc, *flags, "-c", "-o", str(obj), str(CSRC / src)]
                for src, obj in zip(SOURCES, objs)]
        cmds.append([nvcc, *NVCC_FLAGS[:4], "-shared", "-o", str(tmp_dir / _LIB_NAME),
                     *map(str, objs)])
        procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                 for c in cmds[:-1]]
        results = [(c, *pr.communicate(), pr.returncode) for c, pr in zip(cmds, procs)]
        if all(rc == 0 for *_, rc in results):
            link = subprocess.run(cmds[-1], capture_output=True, text=True)
            results.append((cmds[-1], link.stdout, link.stderr, link.returncode))
        log = "".join(" ".join(c) + "\n" + out + err for c, out, err, _ in results)
        failed = [(c, rc) for c, _, _, rc in results if rc != 0]
        if failed:
            cmd, rc = failed[0]
            raise RuntimeError(f"nvcc failed ({rc}): {' '.join(cmd)}\n{log}")
        os.replace(tmp_dir / _LIB_NAME, lib_path)
    finally:
        shutil.rmtree(tmp_dir, ignore_errors=True)
    seconds = time.perf_counter() - t0
    (out_dir / "build.log").write_text(log)
    build_info.update(path=str(lib_path), seconds=seconds, cached=False, log=log)
    return lib_path


def _declare(lib: ctypes.CDLL) -> None:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    parr, iarr = ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int)
    lib.mpgan_edge_aggregate.argtypes = [
        p, p, p, p, p, i, i, i, i, parr, parr, iarr, f, i, i, i, i, i, i, p,
    ]
    lib.mpgan_edge_aggregate.restype = i
    lib.mpgan_edge_aggregate_train.argtypes = [
        p, p, p, p, p, i, i, i, i, parr, parr, iarr, f, i, p, ctypes.c_uint, f, i, i, i, i, i, p,
    ]
    lib.mpgan_edge_aggregate_train.restype = i
    lib.mpgan_edge_aggregate_bwd.argtypes = [
        p, p, p, p, p, p, p, p, p, p, i, i, i, i, parr, p, parr, iarr,
        f, i, i, p, ctypes.c_uint, f, i, i, i, i, i, i, p,
    ]
    lib.mpgan_edge_aggregate_bwd.restype = i
    lib.mpgan_edge_aggregate_fn.argtypes = [
        p, p, p, p, p, p, i, i, i, i, i, parr, parr, iarr, i, parr, p, parr, iarr, f, i, f, i,
        i, i, i, i, i, i, p,
    ]
    lib.mpgan_edge_aggregate_fn.restype = i
    ll = ctypes.c_longlong
    lib.mpgan_edge_aggregate_bf16.argtypes = [
        p, p, p, p, p, ll, i, i, i, i, parr, parr, iarr, f, i, i, p, ctypes.c_uint, f,
        i, i, i, i, i, i, p,
    ]
    lib.mpgan_edge_aggregate_bf16.restype = i
    lib.mpgan_edge_aggregate_fn_bf16.argtypes = [
        p, p, p, p, p, p, ll, p, i, i, i, i, i, parr, parr, iarr, i, parr, p, parr, iarr, f, i, f,
        i, i, i, i, i, i, i, i, p,
    ]
    lib.mpgan_edge_aggregate_fn_bf16.restype = i
    lib.mpgan_edge_aggregate_bwd_bf16.argtypes = [
        p, p, p, p, p, p, p, p, p, p, i, i, i, i, parr, p, ll, parr, iarr,
        f, i, i, p, ctypes.c_uint, f, i, i, i, i, i, i, p,
    ]
    lib.mpgan_edge_aggregate_bwd_bf16.restype = i
    lib.mpgan_edge_fwd_packed_floats_bf16.argtypes = [i, iarr, i, iarr]
    lib.mpgan_edge_fwd_packed_floats_bf16.restype = ll
    lib.mpgan_bf16_tile_smem.argtypes = [i, iarr] + [i] * 11 + [i, iarr, i]
    lib.mpgan_bf16_tile_smem.restype = ll
    lib.mpgan_edge_bwd_packed_floats_bf16.argtypes = [i, iarr, i]
    lib.mpgan_edge_bwd_packed_floats_bf16.restype = ll
    lib.mpgan_edge_fwd_sizes.argtypes = [
        i, iarr, i, iarr, i, i, i, ctypes.POINTER(ctypes.c_longlong),
    ]
    lib.mpgan_edge_fwd_sizes.restype = i
    lib.mpgan_edge_bwd_packed_floats.argtypes = [i, iarr, i]
    lib.mpgan_edge_bwd_packed_floats.restype = ctypes.c_longlong
    lib.mpgan_edge_bwd_wslab_floats.argtypes = [i, iarr, i]
    lib.mpgan_edge_bwd_wslab_floats.restype = i
    lib.mpgan_knn_fused_layer.argtypes = [
        p, p, p, p, p, p, p, p, p, i, i, i, i, i, i, i, i, parr, parr, iarr, f, i, i, p,
        ctypes.c_uint, f, i, i, i, i, i, i, p,
    ]
    lib.mpgan_knn_fused_layer.restype = i
    lib.mpgan_knn_edge_aggregate_bwd.argtypes = [
        p, p, p, p, p, p, p, p, p, p, p, p, p, i, i, i, i, i, parr, p, parr, iarr,
        f, i, i, p, ctypes.c_uint, f, i, i, i, i, i, i, p,
    ]
    lib.mpgan_knn_edge_aggregate_bwd.restype = i
    lib.mpgan_knn_search.argtypes = [p, p, p, p, i, i, i, i, i, i, p]
    lib.mpgan_knn_search.restype = i
    lib.mpgan_knn_edge_aggregate.argtypes = [
        p, p, p, p, p, p, p, i, i, i, i, i, parr, parr, iarr, f, i, i, p, ctypes.c_uint, f,
        i, i, i, i, i, p,
    ]
    lib.mpgan_knn_edge_aggregate.restype = i
    lib.mpgan_knn_fused_layer_bf16.argtypes = [
        p, p, p, p, p, p, p, p, p, ll, i, i, i, i, i, i, i, i, parr, parr, iarr, f, i, i, p,
        ctypes.c_uint, f, i, i, i, i, i, i, i, p,
    ]
    lib.mpgan_knn_fused_layer_bf16.restype = i
    lib.mpgan_knn_edge_aggregate_bwd_bf16.argtypes = [
        p, p, p, p, p, p, p, p, p, p, p, p, p, i, i, i, i, i, parr, p, ll, parr, iarr,
        f, i, i, p, ctypes.c_uint, f, i, i, i, i, i, i, p,
    ]
    lib.mpgan_knn_edge_aggregate_bwd_bf16.restype = i
    lib.mpgan_knn_search_bf16.argtypes = [p, p, p, p, i, i, i, i, i, i, p]
    lib.mpgan_knn_search_bf16.restype = i
    lib.mpgan_knn_edge_aggregate_bf16.argtypes = [
        p, p, p, p, p, p, p, ll, i, i, i, i, i, parr, parr, iarr, f, i, i, p, ctypes.c_uint, f,
        i, i, i, i, i, i, p,
    ]
    lib.mpgan_knn_edge_aggregate_bf16.restype = i
    lib.mpgan_knn_fwd_sizes.argtypes = [i, iarr] + [i] * 10 + [ctypes.POINTER(ctypes.c_longlong)]
    lib.mpgan_knn_fwd_sizes.restype = i
    lib.mpgan_gapt_fused_plan.argtypes = [i, i, i, i, iarr, ctypes.POINTER(ctypes.c_longlong)]
    lib.mpgan_gapt_fused_plan.restype = i
    lib.mpgan_gapt_fused.argtypes = [p] * 12 + [i] * 6 + [f] + [i] * 4 + [p]
    lib.mpgan_gapt_fused.restype = i
    lib.mpgan_gapt_fused_bf16.argtypes = [p] * 12 + [i] * 6 + [f] + [i] * 4 + [p]
    lib.mpgan_gapt_fused_bf16.restype = i
    lib.mpgan_gapt_item_smem.argtypes = [i] * 6 + [ctypes.POINTER(ctypes.c_longlong)]
    lib.mpgan_gapt_item_smem.restype = i
    lib.mpgan_threefry_draws.argtypes = [p, p, i, i, p, p, p, i, i, p, i, i, p]
    lib.mpgan_threefry_draws.restype = i
    lib.mpgan_cuda_error_string.argtypes = [i]
    lib.mpgan_cuda_error_string.restype = ctypes.c_char_p


def library(defines=None) -> ctypes.CDLL:
    """The loaded kernel library, built on first call. A process holds one build:
    ``defines`` (see ``build``) are given on the call that loads it, before any
    wrapper has run, and a later call that names others raises."""
    global _lib, _lib_defines
    with _lock:
        if _lib is None:
            _lib_defines = tuple(defines or ())
            lib = ctypes.CDLL(str(build(_lib_defines)))
            _declare(lib)
            _lib = lib
        elif defines is not None and tuple(defines) != _lib_defines:
            raise RuntimeError(f"the kernel library is already loaded with defines "
                               f"{_lib_defines}, not {tuple(defines)}")
        return _lib


def check(code: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error code."""
    if code != 0:
        msg = library().mpgan_cuda_error_string(code).decode()
        raise RuntimeError(f"{what} failed: CUDA error {code} ({msg})")
