"""Build and load the hand-written CUDA kernels in ``crt_tpu_torch/csrc``.

The kernels are compiled with nvcc for Hopper (``sm_90a``) into a shared
library with a plain C interface and bound with ``ctypes``.  The build
happens at the first CUDA use, into
``build/crt_tpu_torch/<hash of sources and flags>/`` beside the package,
and later processes reuse it.  ``-fmad=false`` (and no fast math) makes
every ``a*b+c`` round the way PyTorch's eager ops round, so the kernels can
be held to their plain versions bit for bit.

Nothing here runs at import time.
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
import time
from typing import NamedTuple

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = pathlib.Path(__file__).resolve().parents[2] / "build" / "crt_tpu_torch"
SOURCES = ("closest_hit.cu", "occlusion_w.cu", "occlusion_d.cu",
           "stream_trace.cu", "segsum.cu", "cluster_bin.cu", "stream_bin.cu")
HEADERS = ("cluster_common.cuh", "bin_common.cuh")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
    "--threads", "0",  # one compile per source, side by side
    "-Xptxas", "-v",  # registers / spills into build.log
)
LIB_NAME = "libcrt_tpu_torch_kernels.so"


class BuildInfo(NamedTuple):
    path: str  # the loaded shared library
    seconds: float  # time spent in nvcc (0 on a cache hit)
    cache_hit: bool
    log: str  # nvcc's output (ptxas register and spill report)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _digest(csrc: pathlib.Path) -> str:
    h = hashlib.sha256()
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((csrc / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build(csrc: pathlib.Path = CSRC) -> BuildInfo:
    """Compile the kernels of ``csrc`` (this package's by default; another
    checkout's sources of the same files to time them in turns) unless an
    identical build exists; return where."""
    csrc = pathlib.Path(csrc)
    out_dir = BUILD_ROOT / _digest(csrc)
    lib = out_dir / LIB_NAME
    log_path = out_dir / "build.log"
    if lib.exists():
        log = log_path.read_text() if log_path.exists() else ""
        return BuildInfo(str(lib), 0.0, True, log)

    out_dir.mkdir(parents=True, exist_ok=True)
    # Build into a temporary name and rename: concurrent first users never
    # load a half-written library.
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(csrc), "-o", tmp,
           *(str(csrc / s) for s in SOURCES)]
    start = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - start
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
    log_path.write_text(log)
    os.replace(tmp, lib)
    return BuildInfo(str(lib), seconds, False, log)


@functools.lru_cache(maxsize=None)
def load() -> tuple[ctypes.CDLL, BuildInfo]:
    """Build (first use) and load the library; bind its entry points."""
    info = build()
    return bind(info.path), info


def bind(path: str) -> ctypes.CDLL:
    """Load the library at ``path`` and declare its entry points."""
    lib = ctypes.CDLL(path)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.crt_closest_hit.argtypes = [p] * 11 + [i] * 4 + [p] * 4
    lib.crt_closest_hit.restype = i
    lib.crt_closest_hit_compact.argtypes = [p] * 12 + [i] * 5 + [p] * 4
    lib.crt_closest_hit_compact.restype = i
    lib.crt_live_tiles.argtypes = [p, i, p, p]
    lib.crt_live_tiles.restype = i
    # the shadow kernels' walk stats come last, after the stream
    lib.crt_occlusion_w.argtypes = [p] * 11 + [i] * 7 + [p] * 4
    lib.crt_occlusion_w.restype = i
    lib.crt_occlusion_d.argtypes = [p] * 11 + [i] * 4 + [p] * 3
    lib.crt_occlusion_d.restype = i
    lib.crt_closest_hit_merged.argtypes = [p] * 11 + [i] * 5 + [p] * 4
    lib.crt_closest_hit_merged.restype = i
    lib.crt_closest_hit_stream.argtypes = ([p] * 2 + [i] + [p] * 13
                                           + [i] * 6 + [p] * 4)
    lib.crt_closest_hit_stream.restype = i
    lib.crt_occlusion_stream.argtypes = ([p] * 3 + [i] + [p] * 12 + [i] * 6
                                         + [p] * 2)
    lib.crt_occlusion_stream.restype = i
    lib.crt_segment_accumulate.argtypes = [p, p, i, i, i, p, p]
    lib.crt_segment_accumulate.restype = i
    lib.crt_cluster_bin.argtypes = ([p] * 8 + [i] * 7 + [ctypes.c_float]
                                    + [p] * 3)
    lib.crt_cluster_bin.restype = i
    lib.crt_stream_bin.argtypes = ([p] * 7 + [i] * 6 + [ctypes.c_float]
                                   + [p] * 7)
    lib.crt_stream_bin.restype = i
    lib.crt_stream_pack.argtypes = ([p] * 7 + [i] * 4 + [ctypes.c_float]
                                    + [p] * 3)
    lib.crt_stream_pack.restype = i
    return lib
