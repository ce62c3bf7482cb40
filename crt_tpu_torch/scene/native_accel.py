"""ctypes bridge to the native helpers: the KD builder
(``native/crt_accel.cpp``) here, the P3 formatter (``native/crt_ppm.cpp``)
through ``io/native_ppm.py`` and the PNG row filters
(``crt_tpu_torch/io/png_unfilter.cpp``) through ``io/png.py``.

The calling convention is crt_tpu's (``crt_tpu/scene/native_accel.py``).
The library is built differently: ``native/build.py`` writes
``native/libcrt_accel.so``, a file of the repository, so this module never
calls it.  ``library()`` compiles the three sources with g++ at first use
into ``build/crt_tpu_torch/native-<hash>/`` beside the package
(gitignored), keyed by the sources, the flags and the compiler's
``-march=native`` target (its predefined macros), so a build made on
another host is not loaded here.  Later processes reuse it.  Callers catch
the errors and fall back to the NumPy builder, the Python formatter and
the NumPy row filters, which give the same result.  Nothing here runs at
import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import subprocess
import tempfile

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[2]
NATIVE = ROOT / "native"
BUILD_ROOT = ROOT / "build" / "crt_tpu_torch"
SOURCES = (NATIVE / "crt_accel.cpp", NATIVE / "crt_ppm.cpp",
           ROOT / "crt_tpu_torch" / "io" / "png_unfilter.cpp")
CXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-shared", "-fPIC")
LIB_NAME = "libcrt_native.so"


def _target_digest() -> bytes:
    """The compiler's predefined macros for ``-march=native``: its version
    and the instruction sets it will emit on this host."""
    proc = subprocess.run(
        ["g++", "-march=native", "-dM", "-E", "-x", "c++", os.devnull],
        capture_output=True, text=True, check=True)
    return proc.stdout.encode()


def build() -> str:
    """Compile the native helpers unless an identical build exists; return
    the library's path.  Raises when g++ is missing or fails."""
    h = hashlib.sha256()
    for src in SOURCES:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    h.update(_target_digest())
    out_dir = BUILD_ROOT / f"native-{h.hexdigest()[:16]}"
    lib = out_dir / LIB_NAME
    if lib.exists():
        return str(lib)
    out_dir.mkdir(parents=True, exist_ok=True)
    # Build into a temporary name and rename: concurrent first users never
    # load a half-written library.
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    try:
        proc = subprocess.run(
            ["g++", *CXX_FLAGS, *(str(s) for s in SOURCES),
             "-o", tmp], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed ({proc.returncode}):\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return str(lib)


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """Build (first use) and load the library; declare its entry points."""
    lib = ctypes.CDLL(build())
    p, i32 = ctypes.c_void_p, ctypes.c_int32
    lib.crt_accel_build.restype = p
    lib.crt_accel_build.argtypes = [p, p, i32, i32, i32]
    for name in ("crt_accel_num_nodes", "crt_accel_num_leaves",
                 "crt_accel_max_leaf_count"):
        fn = getattr(lib, name)
        fn.restype = i32
        fn.argtypes = [p]
    lib.crt_accel_export.restype = None
    # (h, node_min, node_max, node_children, node_leaf_id, leaf_tris,
    #  leaf_stride, leaf_node)
    lib.crt_accel_export.argtypes = [p, p, p, p, p, p, i32, p]
    lib.crt_accel_free.restype = None
    lib.crt_accel_free.argtypes = [p]
    lib.crt_ppm_format.restype = ctypes.c_longlong
    lib.crt_ppm_format.argtypes = [p, i32, i32, i32, p, ctypes.c_longlong]
    lib.crt_png_unfilter.restype = i32
    # (raw [h, 1 + l], h, l, bpp, out [h, l])
    lib.crt_png_unfilter.argtypes = [p, ctypes.c_int64, ctypes.c_int64, i32,
                                     p]
    return lib


def build_host(tmin: np.ndarray, tmax: np.ndarray, max_depth: int,
               max_leaf: int):
    """The return contract of ``accel._build_host``: (node_min [N] of [3],
    node_max, node_children [N] of [2], leaf_lists {node id: tris})."""
    lib = library()
    tmin = np.ascontiguousarray(tmin, np.float32)
    tmax = np.ascontiguousarray(tmax, np.float32)
    T = len(tmin)
    if T <= 0:
        # crt_accel_build returns nullptr for empty input
        raise ValueError("cannot build an acceleration tree over 0 triangles")
    h = lib.crt_accel_build(tmin.ctypes.data, tmax.ctypes.data, T,
                            max_depth, max_leaf)
    try:
        N = lib.crt_accel_num_nodes(h)
        L = lib.crt_accel_num_leaves(h)
        stride = max(1, lib.crt_accel_max_leaf_count(h))
        node_min = np.empty((N, 3), np.float32)
        node_max = np.empty((N, 3), np.float32)
        node_children = np.empty((N, 2), np.int32)
        node_leaf_id = np.empty(N, np.int32)
        leaf_tris = np.full((L, stride), -1, np.int32)
        leaf_node = np.empty(L, np.int32)
        lib.crt_accel_export(
            h, node_min.ctypes.data, node_max.ctypes.data,
            node_children.ctypes.data, node_leaf_id.ctypes.data,
            leaf_tris.ctypes.data, stride, leaf_node.ctypes.data)
    finally:
        lib.crt_accel_free(h)
    leaf_lists = {int(leaf_node[li]): row[row >= 0].astype(np.int32)
                  for li, row in enumerate(leaf_tris)}
    return (list(node_min), list(node_max),
            [list(c) for c in node_children], leaf_lists)
