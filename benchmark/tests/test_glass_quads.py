"""The ``glass_quads`` scene kind and its reference renderer: the scene is
the port's glass scene; the reference agrees with the port's frames on the
CPU and its bfloat16 twin does not; refraction, the Fresnel blend, total
internal reflection and the transmissive shadow march on cases worked by
hand; the reference loads nothing of the program; and the two cells this
configuration and the GI fit mix bring run ``correct`` at the tests'
size, their controls not."""

import json
import math
import subprocess
import sys

import numpy as np
import pytest
import torch

from bench_setup import BENCH, ROOT, added_cell

import run
from harness import driver, traffic
from harness.registry import load_module

CPU = torch.device("cpu")
KIND = load_module(BENCH / "scenes" / "glass_quads.py", "bench_scene")
CONFIG = json.loads((BENCH / "configs" / "quads64_glass_1080p.json"
                     ).read_text())
LIMIT = json.loads((BENCH / "checks" / "quads64.glass_frames.json"
                    ).read_text())["limits"]["px_off_share"]
TINY = {**CONFIG["scene"], "width": 48, "height": 32}


def _off_share(got, ref, tol=1e-3):
    gap = (got.double() - ref.double()).abs().amax(-1)
    bad = (gap > tol * (1.0 + ref.double().abs().amax(-1))) \
        | ~torch.isfinite(got).all(-1)
    return float(bad.double().mean())


@pytest.mark.parametrize("size", [(1920, 1080), (48, 32)])
def test_description_is_the_ports_glass_scene(size):
    from crt_tpu_torch.scene.procedural import make_test_scene_dict

    p = {**CONFIG["scene"], "width": size[0], "height": size[1]}
    assert KIND.description(p) == make_test_scene_dict(
        size[0], size[1], num_quads=64, seed=0, with_refractive=True)


def test_reference_scene_carries_ior_and_the_programs_textures():
    desc = KIND.description(TINY)
    s = KIND.reference_scene(desc)
    prog = KIND.program_scene(desc, CPU)
    assert s.mat_ior.tolist() == [1.0, 1.0, 1.0, 1.5]
    assert s.mat_type.tolist() == [0, 0, 1, 2]
    np.testing.assert_array_equal(s.params["tex_color_a"],
                                  prog.tex_color_a.double().numpy())
    assert torch.equal(torch.as_tensor(s.mat_ior, dtype=torch.float32),
                       prog.mat_ior)


def test_gi_has_no_reference():
    with pytest.raises(ValueError, match="no GI"):
        KIND.description(TINY, gi_on=True)


@pytest.mark.parametrize("seed", [3, 17, 2 ** 31 + 17])
def test_reference_matches_the_port_and_bfloat16_does_not(seed):
    """A whole 48 x 32 frame with the first camera of the seed's jitter
    pattern: within the cell's limit, and its bfloat16 twin over it."""
    from crt_tpu_torch import renderer
    from crt_tpu_torch.scene.types import RenderSettings

    desc = KIND.description(TINY)
    s = KIND.reference_scene(desc)
    rot = traffic.jitter_rotations(seed, s.cam_rotation, s.tan_half_fov,
                                   s.height, 16)[0]
    scene = KIND.program_scene(desc, CPU).replace(
        cam_rotation=torch.from_numpy(rot))
    got = renderer.render_image(scene, RenderSettings(**CONFIG["settings"]))
    got = got.reshape(-1, 3)
    refs = [KIND.Renderer(s, dtype=dt, device=CPU).frame(rot).reshape(-1, 3)
            for dt in (torch.float64, torch.bfloat16)]
    assert _off_share(got, refs[0]) <= LIMIT
    assert _off_share(refs[1], refs[0]) > LIMIT


# -- cases worked by hand ------------------------------------------------------

def _unit_scene(sheet_type: str, sheet):
    """A floor at y = -2, one light above it at (0, 6, 0), and one
    triangle ``sheet`` of material ``sheet_type`` between them."""
    sheet_mat = {"type": sheet_type, "smooth_shading": False}
    if sheet_type == "refractive":
        sheet_mat["ior"] = 1.5
    else:
        sheet_mat["albedo"] = [0.5, 0.5, 0.5]
    return KIND.reference_scene({
        "settings": {"background_color": [0.1, 0.2, 0.3],
                     "image_settings": {"width": 4, "height": 4}},
        "camera": {"matrix": [1, 0, 0, 0, 1, 0, 0, 0, 1],
                   "position": [0, 0, 6]},
        "lights": [{"intensity": 800, "position": [0, 6, 0]}],
        "materials": [{"type": "diffuse", "albedo": [0.7, 0.7, 0.7],
                       "smooth_shading": False}, sheet_mat],
        "objects": [
            {"material_index": 0,
             "vertices": [-20, -2, 20, 20, -2, 20, -20, -2, -20,
                          20, -2, -20],
             "triangles": [0, 1, 2, 3, 2, 1]},
            {"material_index": 1, "vertices": sheet, "triangles": [0, 1, 2]},
        ]})


# a sheet across the floor point's ray to the light, tilted so the ray
# bends where it enters
TILTED = [-3, 1.5, 3, 3, 1.5, 3, 0, 2.5, -3]


def _t(*x):
    return torch.tensor(x, dtype=torch.float64)


def test_normal_incidence_refracts_unbent_with_fresnel_zero():
    n = _t(0.0, 0.0, 1.0)[None]
    d = -n
    out, ok = KIND.refract(d, n, _t(1.0), _t(1.5))
    assert bool(ok[0]) and torch.allclose(out, d, atol=1e-15)
    # the Renderer's blend there is the refracted colour alone
    r = KIND.Renderer(_unit_scene("refractive", TILTED), device=CPU)
    p = _t(0.0, 0.0, 0.0)[None]
    glass = r.glass(d, p, n, _t(1.5), 0)
    through = r.shade(p - n * r.bias, d, 1)
    assert torch.equal(glass, through)


def test_total_internal_reflection_past_the_critical_angle():
    """Leaving glass (d.n > 0) at 60 degrees from the normal, past
    asin(1 / 1.5) = 41.8 degrees: no refraction, the reflection alone."""
    n = _t(0.0, 0.0, 1.0)[None]
    a = math.radians(60.0)
    d = _t(math.sin(a), 0.0, math.cos(a))[None]
    flipped, eta_i, eta_t = KIND.facing(d, n, _t(1.5))
    assert torch.equal(flipped, -n) and float(eta_i) == 1.5
    _, ok = KIND.refract(d, flipped, eta_i, eta_t)
    assert not bool(ok[0])
    b = math.radians(40.0)  # inside the critical angle: it refracts
    assert bool(KIND.refract(_t(math.sin(b), 0.0, math.cos(b))[None],
                             flipped, eta_i, eta_t)[1][0])
    r = KIND.Renderer(_unit_scene("refractive", TILTED), device=CPU)
    p = _t(0.0, 0.0, 0.0)[None]
    reflected = d - flipped * (2.0 * (d * flipped).sum(-1))[:, None]
    assert torch.equal(r.glass(d, p, n, _t(1.5), 0),
                       r.shade(p + flipped * r.bias, reflected, 1))


def test_a_shadow_ray_through_one_glass_sheet_reaches_the_light():
    p = _t(0.0, -2.0, 0.0)[None]
    up = _t(0.0, 1.0, 0.0)[None]
    albedo = _t(0.7, 0.7, 0.7)[None]
    lit = 0.7 * 800.0 / (4.0 * math.pi * 64.0)
    glass = KIND.Renderer(_unit_scene("refractive", TILTED), device=CPU)
    ld = _t(0.0, 1.0, 0.0)[None]
    assert not bool(glass.march(p + up * glass.bias, ld, _t(64.0))[0])
    assert float(glass.direct(p, up, albedo)[0, 0]) == pytest.approx(lit)
    opaque = KIND.Renderer(_unit_scene("diffuse", TILTED), device=CPU)
    assert bool(opaque.march(p + up * opaque.bias, ld, _t(64.0))[0])
    assert float(opaque.direct(p, up, albedo)[0, 0]) == 0.0


def test_the_reference_loads_nothing_of_the_program():
    code = (
        "import sys; sys.path[:0] = [%r, %r]\n"
        "import pathlib, numpy as np, torch\n"
        "from harness.registry import load_module\n"
        "k = load_module(pathlib.Path(%r), 'k')\n"
        "p = dict(width=8, height=6, num_quads=64, layout_seed=0)\n"
        "s = k.reference_scene(k.description(p))\n"
        "k.Renderer(s).frame(np.eye(3, dtype=np.float32))\n"
        "tops = {m.split('.')[0] for m in sys.modules}\n"
        "assert not tops & {'crt_tpu_torch', 'crt_tpu', 'jax'}, tops\n"
        "print('ok')\n" % (str(ROOT), str(BENCH),
                           str(BENCH / "scenes" / "glass_quads.py")))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0 and "ok" in out.stdout, out.stderr[-2000:]


# -- the new cells, as new files alone -------------------------------------------

CELLS = {
    "quads64.glass_frames": ("quads64_glass_1080p", "frames"),
    "quads64.gi_fit": ("quads64_1080p", "gi_fit"),
}


@pytest.mark.parametrize("name", sorted(CELLS))
def test_new_cell_is_correct_and_its_control_is_not(tmp_path, name):
    config, mix = CELLS[name]
    check = json.loads((BENCH / "checks" / f"{name}.json").read_text())
    cell = added_cell(tmp_path, name, (config, None), (mix, None), check)
    res = run.run_cell(cell, 2 ** 31 + 17, 0.3, False, CPU)
    assert res["correct"], res["checks"]
    r = driver.make(cell, CPU, 5, 0.0)
    r.run(0.2, False)
    r.free()
    numbers = r.compare(control=True)["numbers"]
    assert not all(v <= cell.check["limits"][k] for k, v in numbers.items())
