"""The process-wide fp32 settings a caller of the port may choose, for the
checks that the render path ignores them (``tests/test_torch_cuda.py``
and ``chip_smoke.py``'s ``[precision]``).

``"tf32"`` switches TF32 on everywhere torch offers it: cuBLAS
(``torch.backends.cuda.matmul.fp32_precision``), cuDNN convolutions
(``torch.backends.cudnn.conv.fp32_precision``) and the matmul precision
``"medium"``.  ``"ieee"`` switches it off everywhere.  Needs torch only.
"""

import contextlib

import torch

LEGACY = {"tf32": "medium", "ieee": "highest"}


def read_fp32() -> tuple:
    """(cuBLAS fp32 precision, cuDNN conv fp32 precision, matmul
    precision), as a caller reads them back."""
    return (torch.backends.cuda.matmul.fp32_precision,
            torch.backends.cudnn.conv.fp32_precision,
            torch.get_float32_matmul_precision())


@contextlib.contextmanager
def global_fp32(mode: str):
    """Set every fp32 switch to ``mode`` ("tf32" or "ieee") for the block
    and yield what ``read_fp32`` must then give; the process's settings
    are put back after it."""
    matmul, conv = torch.backends.cuda.matmul, torch.backends.cudnn.conv
    before = (matmul.fp32_precision, conv.fp32_precision)
    torch.set_float32_matmul_precision(LEGACY[mode])
    matmul.fp32_precision = mode
    conv.fp32_precision = mode
    try:
        yield (mode, mode, LEGACY[mode])
    finally:
        torch.set_float32_matmul_precision("highest")
        matmul.fp32_precision, conv.fp32_precision = before


def under(mode: str, fn):
    """``fn()`` with every fp32 switch at ``mode``; raises AssertionError
    unless the settings read back unchanged after it."""
    with global_fp32(mode) as want:
        out = fn()
        torch.cuda.synchronize()
        got = read_fp32()
        assert got == want, f"the render left the fp32 settings at {got}, " \
            f"set to {want}"
    return out
