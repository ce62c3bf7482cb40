"""ctypes bridge to the native ASCII P3 formatter (``native/crt_ppm.cpp``),
in the library ``scene/native_accel.py`` builds.

``io/ppm.format_ppm`` routes through it and falls back to the Python
formatter where the library will not build; the bytes are the same.
"""

from __future__ import annotations

import ctypes

import numpy as np


def format_ppm_native(arr: np.ndarray, max_color_component: int) -> str:
    """[H,W,3] int image (already quantized) -> ASCII P3 string."""
    from crt_tpu_torch.scene.native_accel import library

    arr = np.ascontiguousarray(arr, np.int32)
    h, w, _ = arr.shape
    cap = 64 + h * w * 3 * 5 + h
    buf = ctypes.create_string_buffer(cap)
    n = library().crt_ppm_format(arr.ctypes.data, h, w, max_color_component,
                                 buf, cap)
    if n < 0:
        raise RuntimeError("crt_ppm_format buffer too small")
    return buf.raw[:n].decode("ascii")
