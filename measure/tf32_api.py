"""How torch's TF32 switches act on the card's cuBLAS products.

    python3 measure/tf32_api.py

Sets the cuBLAS fp32 precision through the new API
(``torch.backends.cuda.matmul.fp32_precision``) and the legacy one
(``torch.set_float32_matmul_precision``), alone and mixed, and after each
step prints what the three settings read back (ERR where torch refuses to
read a mixed state) and the largest error against fp64 of two products:
the all-pairs test's shape, [8192, 3] x [3, 4096], and [512, 64] x [64,
512], where TF32 shows.  The last steps are ``ops/intersect.py``'s scope:
IEEE inside it over a caller's "medium" + "tf32", then the caller's value
put back.  Prints the card's name and power limit first.

Needs one CUDA card.
"""

from __future__ import annotations

import subprocess
import sys

import torch


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    print(sys.version.split()[0], torch.__version__, torch.version.cuda)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
        .stdout.strip())
    matmul = torch.backends.cuda.matmul
    gen = torch.Generator(device="cuda").manual_seed(0)
    shapes = {
        "k3": (torch.randn(8192, 3, device="cuda", generator=gen),
               torch.randn(3, 4096, device="cuda", generator=gen)),
        "k64": (torch.randn(512, 64, device="cuda", generator=gen),
                torch.randn(64, 512, device="cuda", generator=gen)),
    }
    exact = {k: a.double() @ b.double() for k, (a, b) in shapes.items()}

    def settings():
        out = []
        for read in (lambda: matmul.fp32_precision,
                     torch.get_float32_matmul_precision,
                     lambda: torch.backends.cudnn.conv.fp32_precision):
            try:
                out.append(read())
            except RuntimeError:
                out.append("ERR")
        return out

    def step(tag):
        errs = []
        for k, (a, b) in shapes.items():
            try:
                c = a @ b
                torch.cuda.synchronize()
                errs.append(f"{k} err "
                            f"{float((c.double() - exact[k]).abs().max()):.3e}")
            except RuntimeError as e:
                errs.append(f"{k} raises {str(e)[:120]}")
        print(f"{tag}: settings {settings()}; {'; '.join(errs)}", flush=True)

    step("default")
    matmul.fp32_precision = "tf32"
    step("new tf32")
    matmul.fp32_precision = "ieee"
    step("new ieee")
    torch.set_float32_matmul_precision("medium")
    step("legacy medium")
    torch.set_float32_matmul_precision("highest")
    step("legacy highest")
    torch.set_float32_matmul_precision("medium")
    matmul.fp32_precision = "tf32"
    torch.backends.cudnn.conv.fp32_precision = "tf32"
    step("a caller's medium + tf32")
    before = matmul.fp32_precision
    matmul.fp32_precision = "ieee"
    step("inside the scope")
    matmul.fp32_precision = before
    step("after the scope")
    return 0


if __name__ == "__main__":
    sys.exit(main())
