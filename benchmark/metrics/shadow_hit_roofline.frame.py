"""The opaque shadow pass as a share of its roofline: the least time the
frozen partition, shaft binning and plain trace of
``harness/shadow_bound.py`` say a frame's pass needs, over the device
time launched under the program's ``crt.trace.shadow`` spans, summed over
the traced frames.  The bound is reckoned for the first traced frame's
camera and counted once for each traced frame: the frames differ by a
sub-pixel turn of the camera."""

import torch

from harness.program_trace import program_spans
from harness.shadow_bound import shadow_hit_bound
from harness.trace import device_ms_under


def read(ctx):
    t = program_spans(ctx.trace)
    spent = None if t is None else device_ms_under(t, "crt.trace.shadow")
    if not spent or ctx.unit != "frame" or not ctx.window.units:
        return None
    r = ctx.runner
    ref = r.kind.Renderer(r.ref_scene, dtype=torch.float32, device=r.dev)
    cameras = r.traced_cameras(ctx.window)
    bound = shadow_hit_bound(ref, cameras[0])["bound_ms"] * len(cameras)
    return 100.0 * bound / spent
