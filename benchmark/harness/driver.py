"""One run of one cell: set-up, the measured (or traced) window, and the
check of what the window produced against the plain reference.

Two kinds of unit, as the traffic mix says:

  - ``frame``: ``renderer.render_image`` of the configuration's scene, the
    camera turned by the frame's jitter and / or the frame's GI pass salt;
    every frame of the window keeps the colours of a fixed sample of
    pixels, which the check compares;
  - ``step``: one step of one ``optim.fit_scene`` call, its target
    rendered in set-up from the perturbed parameters; its first steps are
    set-up and are what the check compares, the later ones the window.

Both take the scene from the configuration's kind (``harness/scenes.py``:
``quads``, ``soup`` or a module ``benchmark/scenes/<kind>.py`` of the
configuration's own), and both honour the mix's ``gi``: with ``"gi":
true`` the scene renders with diffuse GI, frames on their progressive
pass's salt, fit steps and their target unsalted, as ``fit_scene``
renders.  Each check builds the kind's reference ``Renderer``; a fit's
check renders the reference frame in blocks of the check file's
``pixel_block`` pixels where it names one.

Each unit ends in a device synchronize; the window closes at the end of
the unit that crosses ``seconds``, so its length is all the time of all
its units.  The garbage collector runs once just before the window: the
stream trace's closures hold a frame's tables in a reference cycle until
a collection, so without it the window's peak memory would follow the
collector's phase, which any change to set-up's Python shifts (by one
1 M-triangle table set, 144 MiB).
"""

from __future__ import annotations

import gc
import math
import time
from dataclasses import dataclass, field

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from harness import scenes
from harness import traffic as tr
from harness.trace import Trace, from_events


class _WindowClosed(Exception):
    pass


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _mem_reset(device):
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def _mem_peak(device) -> int:
    return torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0


@dataclass
class Window:
    units: int = 0
    seconds: float = 0.0
    unit_s: list = field(default_factory=list)
    setup_s: float = 0.0
    setup_peak: int = 0
    window_peak: int = 0
    trace: Trace | None = None


def _profiler(device):
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts)


class FrameCell:
    """A cell whose unit is a frame of ``render_image``."""

    unit = "frame"

    def __init__(self, cell, device, seed: int, t0: float):
        from crt_tpu_torch import renderer
        from crt_tpu_torch.scene.types import RenderSettings

        self.renderer = renderer
        self.cell, self.dev, self.seed, self.t0 = cell, device, seed, t0
        tf = cell.traffic
        self.gi = bool(tf.get("gi", False))
        self.jitter = bool(tf.get("jitter", False))
        self.kind = scenes.find(cell.config, cell.bench_dir)
        self.desc = self.kind.description(cell.config["scene"], self.gi)
        self.ref_scene = self.kind.reference_scene(self.desc)
        self.settings = RenderSettings(**cell.config.get("settings", {}))
        self.scene = self.kind.program_scene(self.desc, device)
        self.W, self.H = self.ref_scene.width, self.ref_scene.height
        self.rots = None
        if self.jitter:
            self.pattern = int(tf["jitter_pattern"])
            self.rots_np = tr.jitter_rotations(
                seed, self.ref_scene.cam_rotation, self.ref_scene.tan_half_fov,
                self.H, self.pattern)
            self.rots = torch.from_numpy(self.rots_np).to(device)
        self.idx_np = tr.sample_pixels(seed, self.W, self.H,
                                       int(cell.check["pixels"]))
        self.idx = torch.from_numpy(self.idx_np).to(device)
        self.samples = []  # per window frame: [pixels, 3] on the host
        self.k = 0  # frames rendered so far
        self.first_window_frame = 0

    def camera(self, k: int):
        """The camera matrix of frame k (float32 NumPy)."""
        if self.jitter:
            return self.rots_np[k % self.pattern]
        return self.ref_scene.cam_rotation.astype(np.float32)

    def salt(self, k: int):
        return tr.gi_salt(self.seed, k) if self.gi else None

    def frame(self, keep: bool):
        k = self.k
        sc = self.scene
        if self.jitter:
            sc = sc.replace(cam_rotation=self.rots[k % self.pattern])
        img = self.renderer.render_image(sc, self.settings,
                                         gi_salt=self.salt(k))
        if keep:  # on the host, so the kept samples take no card memory
            self.samples.append(img.reshape(-1, 3)[self.idx].cpu())
        self.k += 1
        _sync(self.dev)

    def run(self, seconds: float, trace: bool) -> Window:
        for _ in range(int(self.cell.traffic["warmup_units"])):
            self.frame(keep=False)
        gc.collect()
        w = Window(setup_peak=_mem_peak(self.dev))
        self.first_window_frame = self.k
        _mem_reset(self.dev)
        limit = int(self.cell.traffic["trace_units"]) if trace else None
        prof = None
        if trace:
            from harness.spans import layer_spans

            spans = layer_spans()
            spans.__enter__()
            prof = _profiler(self.dev)
            prof.__enter__()
        start = time.perf_counter()
        w.setup_s = start - self.t0
        try:
            while True:
                t = time.perf_counter()
                if trace:
                    with record_function("bench.frame"):
                        self.frame(keep=True)
                else:
                    self.frame(keep=True)
                now = time.perf_counter()
                w.unit_s.append(now - t)
                if now - start >= seconds or (limit and len(w.unit_s) >= limit):
                    break
        finally:
            if trace:
                prof.__exit__(None, None, None)
                spans.__exit__(None, None, None)
        w.seconds = now - start
        w.units = len(w.unit_s)
        w.window_peak = _mem_peak(self.dev)
        if trace:
            w.trace = from_events(prof.events(), "bench.frame")
        return w

    def traced_cameras(self, w: Window) -> list:
        """Camera matrices of the traced frames."""
        return [self.camera(self.first_window_frame + j) for j in range(w.units)]

    def free(self):
        self.scene = self.rots = None

    # -- check
    def reference_values(self, dtype, ks) -> list:
        """The reference's colours [pixels, 3] of window frames ``ks``."""
        r = self.kind.Renderer(
            self.ref_scene, dtype=dtype, device=self.dev,
            max_ray_depth=self.settings.max_ray_depth,
            gi_rays=self.settings.diffuse_reflection_ray_count)
        px = torch.from_numpy(self.idx_np % self.W).to(self.dev)
        py = torch.from_numpy(self.idx_np // self.W).to(self.dev)
        out = []
        for j in ks:
            k = self.first_window_frame + j
            with torch.no_grad():
                out.append(r.pixels(px, py, self.camera(k), self.salt(k)))
        return out

    def compare(self, control: bool = False) -> dict:
        """The numbers the check compares: ``px_off_share``, the share of
        compared pixels whose colour is off the reference's by more than
        ``pixel_tol`` * (1 + |reference|) in some channel, or is not
        finite.  ``control``: the reference in bfloat16 takes the
        program's place."""
        ck = self.cell.check
        ks = tr.checked_units(self.seed, len(self.samples), int(ck["frames"]))
        ref = self.reference_values(torch.float64, ks)
        got = (self.reference_values(torch.bfloat16, ks) if control
               else [self.samples[j] for j in ks])
        off = total = 0
        worst = 0.0
        for g, r in zip(got, ref):
            g, r = g.to("cpu", torch.float64), r.to("cpu")
            gap = (g - r).abs().amax(dim=-1)
            bad = (gap > ck["pixel_tol"] * (1.0 + r.abs().amax(dim=-1))) \
                | ~torch.isfinite(g).all(dim=-1)
            off += int(bad.sum())
            total += bad.numel()
            worst = max(worst, float(torch.nan_to_num(gap, nan=math.inf).max()))
        return {"numbers": {"px_off_share": off / max(total, 1)},
                "info": {"frames_checked": len(ks), "pixels_checked": total,
                         "px_widest_gap": worst}}


class FitCell:
    """A cell whose unit is a step of ``optim.fit_scene``."""

    unit = "step"
    CHECKED = 3

    def __init__(self, cell, device, seed: int, t0: float):
        from crt_tpu_torch import optim, renderer
        from crt_tpu_torch.scene.types import RenderSettings

        self.optim = optim
        self.cell, self.dev, self.seed, self.t0 = cell, device, seed, t0
        self.kind = scenes.find(cell.config, cell.bench_dir)
        self.desc = self.kind.description(cell.config["scene"],
                                          bool(cell.traffic.get("gi", False)))
        self.ref_scene = self.kind.reference_scene(self.desc)
        self.settings = RenderSettings(**cell.config.get("settings", {}))
        self.scene = self.kind.program_scene(self.desc, device)
        base = {k: v.astype(np.float32) for k, v in self.ref_scene.params.items()}
        off = tr.perturbation(seed, base, cell.traffic["perturb"])
        self.moved = {k: base[k] + off[k] for k in off}
        with torch.no_grad():
            self.target = renderer.render_image(
                self.scene.replace(**{k: torch.from_numpy(v).to(device)
                                      for k, v in self.moved.items()}),
                self.settings)
        self.record = {}

    def run(self, seconds: float, trace: bool) -> Window:
        warm = max(int(self.cell.traffic["warmup_units"]), self.CHECKED + 1)
        limit = int(self.cell.traffic["trace_units"]) if trace else None
        lr = float(self.cell.traffic["lr"])
        w = Window()
        holder = {}
        rec = self.record
        rec["loss"] = []
        state = {"start": None, "last": None, "prof": None, "span": None,
                 "spans": None}

        def make_opt(ps):
            holder["params"] = list(ps)
            holder["start"] = [p.detach().clone() for p in ps]
            holder["opt"] = torch.optim.Adam(ps, lr=lr)
            return holder["opt"]

        def callback(i, loss):
            _sync(self.dev)
            now = time.perf_counter()
            if i < self.CHECKED:
                rec["loss"].append(loss)
            if i == 0:
                opt = holder["opt"]
                b1 = opt.defaults["betas"][0]
                # a leaf the loss did not reach has no state: gradient 0
                rec["grad0"] = [opt.state[p]["exp_avg"].detach().double()
                                / (1.0 - b1) if "exp_avg" in opt.state[p]
                                else torch.zeros_like(p, dtype=torch.float64)
                                for p in holder["params"]]
            if i == self.CHECKED - 1:
                rec["delta"] = [p.detach().double() - s.double() for p, s in
                                zip(holder["params"], holder["start"])]
            if i < warm - 1:
                return
            if i == warm - 1:
                gc.collect()
                now = time.perf_counter()
                w.setup_peak = _mem_peak(self.dev)
                _mem_reset(self.dev)
                if trace:
                    from harness.spans import layer_spans

                    state["spans"] = layer_spans()
                    state["spans"].__enter__()
                    state["prof"] = _profiler(self.dev)
                    state["prof"].__enter__()
                    state["span"] = record_function("bench.step")
                    state["span"].__enter__()
                state["start"] = state["last"] = now
                w.setup_s = now - self.t0
                return
            w.unit_s.append(now - state["last"])
            state["last"] = now
            if trace:
                state["span"].__exit__(None, None, None)
            if now - state["start"] >= seconds or (limit and len(w.unit_s) >= limit):
                raise _WindowClosed
            if trace:
                state["span"] = record_function("bench.step")
                state["span"].__enter__()

        try:
            self.optim.fit_scene(self.scene, self.target, settings=self.settings,
                                 optimizer=make_opt, steps=1 << 30,
                                 callback=callback)
        except _WindowClosed:
            pass
        finally:
            if state["prof"] is not None:
                state["prof"].__exit__(None, None, None)
                state["spans"].__exit__(None, None, None)
        w.seconds = state["last"] - state["start"]
        w.units = len(w.unit_s)
        w.window_peak = _mem_peak(self.dev)
        if trace:
            w.trace = from_events(state["prof"].events(), "bench.step")
        return w

    def free(self):
        self.scene = self.target = None

    # -- check
    def reference_steps(self, dtype) -> dict:
        from reference.fit import fit_steps, target_frame

        r = self.kind.Renderer(
            self.ref_scene, dtype=dtype, device=self.dev,
            max_ray_depth=self.settings.max_ray_depth,
            gi_rays=self.settings.diffuse_reflection_ray_count)
        rot = self.ref_scene.cam_rotation.astype(np.float32)
        block = self.cell.check.get("pixel_block")
        target = target_frame(r, self.moved, rot, block)
        return fit_steps(r, target, rot, steps=self.CHECKED,
                         lr=float(self.cell.traffic["lr"]), block=block)

    def compare(self, control: bool = False) -> dict:
        """The numbers the check compares, each a relative gap to the
        reference: ``loss_gap``, the largest over the checked steps (under
        GI the first step's alone, below); ``grad_gap`` and ``step_gap``,
        the gap between the norms of a leaf's first gradient (from Adam's
        state after one step) and of its change after the checked steps,
        over the larger of the reference leaf's norm and the median
        leaf's, worst leaf.  Leaves whose reference gradient is under a
        thousandth of the median leaf's are left out.

        Under GI a later step's loss is taken at parameters that have
        rounded apart (the program's float32 against the reference's
        float64), and a GI child ray that crosses a triangle's edge
        between the two moves that loss by a tenth or more where the
        program is right; so only the first step's loss, at the same
        parameters on both sides, is compared, and the later steps are
        ``step_gap``'s."""
        from reference.fit import leaf_norm
        from reference.render import PARAM_KEYS

        ref = self.reference_steps(torch.float64)
        if control:
            low = self.reference_steps(torch.bfloat16)
            got = {"loss": low["loss"],
                   "grad0": [low["grad0"][k] for k in PARAM_KEYS],
                   "delta": [low["delta"][k] for k in PARAM_KEYS]}
        else:
            got = self.record
        steps = 1 if self.ref_scene.gi_on else len(ref["loss"])
        loss_gap = max(_gap(a, b, abs(b)) for a, b in
                       zip(got["loss"][:steps], ref["loss"][:steps]))
        g_ref = [leaf_norm(ref["grad0"][k]) for k in PARAM_KEYS]
        d_ref = [leaf_norm(ref["delta"][k]) for k in PARAM_KEYS]
        g_med, d_med = float(np.median(g_ref)), float(np.median(d_ref))
        kept = [i for i, g in enumerate(g_ref) if g >= 1e-3 * g_med]
        grad_gap = max(_gap(leaf_norm(got["grad0"][i]), g_ref[i],
                            max(g_ref[i], g_med)) for i in kept)
        step_gap = max(_gap(leaf_norm(got["delta"][i]), d_ref[i],
                            max(d_ref[i], d_med)) for i in kept)
        return {"numbers": {"loss_gap": loss_gap, "grad_gap": grad_gap,
                            "step_gap": step_gap},
                "info": {"leaves_kept": [PARAM_KEYS[i] for i in kept],
                         "loss_ref": ref["loss"], "loss_got": got["loss"]}}


def _gap(got: float, ref: float, scale: float) -> float:
    """|got - ref| / scale; infinite where ``got`` is not finite."""
    gap = abs(got - ref) / scale
    return gap if math.isfinite(gap) else math.inf


KINDS = {"frame": FrameCell, "step": FitCell}


def make(cell, device, seed: int, t0: float):
    return KINDS[cell.traffic["unit"]](cell, device, seed, t0)
