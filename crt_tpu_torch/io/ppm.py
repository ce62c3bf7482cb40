"""ASCII PPM (P3) image I/O.

A copy of ``crt_tpu/io/ppm.py`` (importing crt_tpu imports JAX).  Header
``P3\\n<w> <h>\\n<max>\\n``, per pixel ``r g b\\t`` with a newline per row,
channels quantized as ``clamp(int(c * max), 0, max)`` — C truncation
toward zero, no gamma.
"""

from __future__ import annotations

import subprocess

import numpy as np


def quantize(image: np.ndarray, max_color_component: int = 255) -> np.ndarray:
    """float [H,W,3] -> int array: f32 multiply, truncate toward zero,
    clamp to [0, max]."""
    arr = np.asarray(image, np.float32) * np.float32(max_color_component)
    # clamp the float first so inf lanes stay defined when cast
    arr = np.clip(arr, -2147483000.0, 2147483000.0).astype(np.int32)
    return np.clip(arr, 0, max_color_component)


def format_ppm(image, max_color_component: int = 255) -> str:
    """Format a [H,W,3] float image as an ASCII P3 string.

    Routes through the native formatter (``io/native_ppm.py``: the Python
    string loop takes about a second for a 1080p frame) and falls back to
    the Python one, byte for byte the same, where the native library will
    not build.
    """
    arr = quantize(np.asarray(image), max_color_component)
    h, w, _ = arr.shape
    try:
        from crt_tpu_torch.io.native_ppm import format_ppm_native

        return format_ppm_native(arr, max_color_component)
    except (OSError, RuntimeError, subprocess.SubprocessError):
        pass
    return format_ppm_python(arr, max_color_component)


def format_ppm_python(arr: np.ndarray, max_color_component: int) -> str:
    """The Python formatter of a quantized [H,W,3] int image."""
    h, w, _ = arr.shape
    lines = [f"P3\n{w} {h}\n{max_color_component}\n"]
    for row in arr.reshape(h, w * 3):
        it = iter(row.tolist())
        lines.append(
            "".join(f"{r} {g} {b}\t" for r, g, b in zip(it, it, it)) + "\n"
        )
    return "".join(lines)


def write_ppm(image, path_or_file, max_color_component: int = 255) -> None:
    """Write a [H,W,3] float image as ASCII P3."""
    data = format_ppm(image, max_color_component)
    if hasattr(path_or_file, "write"):
        path_or_file.write(data)
    else:
        with open(path_or_file, "w") as f:
            f.write(data)


def read_ppm(path_or_file) -> np.ndarray:
    """Read ASCII P3 -> float32 [H,W,3] in [0,1] (values / max)."""
    if hasattr(path_or_file, "read"):
        text = path_or_file.read()
    else:
        with open(path_or_file) as f:
            text = f.read()
    tokens = text.split()
    if tokens[0] != "P3":
        raise ValueError("only ASCII P3 is supported")
    w, h, maxc = int(tokens[1]), int(tokens[2]), int(tokens[3])
    vals = np.array(tokens[4:4 + w * h * 3], dtype=np.float32)
    return (vals / maxc).reshape(h, w, 3)
