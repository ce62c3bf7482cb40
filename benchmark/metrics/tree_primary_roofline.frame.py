"""The camera rays' KD walk as a share of its roofline: the least time
``harness/tree_bound.py`` says a frame's camera rays need (its frozen
tree, pruned at the reference's hits), over the device time launched
under the program's ``crt.trace.primary`` spans, summed over the traced
frames.  The bound is reckoned for the first traced frame's camera and
counted once for each traced frame: the frames differ by a sub-pixel turn
of the camera.  None where no ``crt.tree.walk`` span was recorded: no KD
walk ran."""

import torch

from harness.program_trace import program_spans
from harness.trace import device_ms_under
from harness.tree_bound import primary_walk_bound


def read(ctx):
    t = program_spans(ctx.trace)
    if t is None or "crt.tree.walk" not in t.spans:
        return None
    spent = device_ms_under(t, "crt.trace.primary")
    if not spent or ctx.unit != "frame" or not ctx.window.units:
        return None
    r = ctx.runner
    ref = r.kind.Renderer(r.ref_scene, dtype=torch.float32, device=r.dev)
    cameras = r.traced_cameras(ctx.window)
    bound = primary_walk_bound(ref, cameras[0])["bound_ms"] * len(cameras)
    return 100.0 * bound / spent
