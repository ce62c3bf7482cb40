"""crt_tpu_torch.optim.fit_scene vs crt_tpu.optim.fit_scene.

The same scene (tests/test_optim.py's: 24x16, 3 quads, no mirror), target
and perturbed start values go through both trainers; the start values
cross as NumPy (``params_from_numpy`` / ``params_to_numpy``).  The port
runs on CPU tensors.

Tolerance: loss curves and fitted parameters at rtol 1e-4.  crt_tpu's step
is jitted, so XLA contracts multiply-adds into FMAs and its image differs
from the port's in the last bits (test_torch_render.py holds images to
rtol 1e-5); Adam's first steps divide a gradient by its own magnitude,
which carries that noise into the parameters at about the same relative
size, and five steps do not amplify it beyond 1e-4.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import crt_tpu
from crt_tpu.optim import fit_scene as jfit_scene
from crt_tpu.scene.procedural import make_test_scene as jmake_test_scene
from crt_tpu_torch import RenderSettings, fit_scene, render_image
from crt_tpu_torch.optim import default_trainable_params, make_loss_fn
from crt_tpu_torch.scene.convert import params_from_numpy, params_to_numpy
from crt_tpu_torch.scene.procedural import make_test_scene
from torch_port_fixtures import _one_torch_thread, _release_heap  # noqa: F401


SCENE_KW = dict(width=24, height=16, num_quads=3, with_reflective=False)


def perturbed_start(scene):
    """Noisy texture colours and dimmed lights, from a NumPy seed."""
    rng = np.random.default_rng(0)
    tex = scene.tex_color_a.numpy()
    noisy = np.clip(tex + rng.normal(scale=0.2, size=tex.shape), 0.05, 1.0)
    return {"tex_color_a": noisy.astype(np.float32),
            "light_intensity": scene.light_intensity.numpy()
            * np.float32(0.9)}


def test_loss_curve_matches_crt_tpu():
    scene = make_test_scene(**SCENE_KW, device="cpu")
    start = perturbed_start(scene)
    params, losses = fit_scene(
        scene, render_image(scene),
        params=params_from_numpy(start, device="cpu"), steps=5)

    jscene = jmake_test_scene(**SCENE_KW)
    jparams, jlosses = jfit_scene(
        jscene, crt_tpu.render_image(jscene, crt_tpu.RenderSettings()),
        params={k: jnp.asarray(v) for k, v in start.items()},
        settings=crt_tpu.RenderSettings(), steps=5)

    assert len(losses) == 5 and losses[-1] < losses[0]
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4)
    fitted = params_to_numpy(params)
    for k in start:
        assert not params[k].requires_grad
        np.testing.assert_allclose(fitted[k], np.asarray(jparams[k]),
                                   rtol=1e-4, err_msg=k)


def test_fit_recovers_albedo():
    scene = make_test_scene(**SCENE_KW, device="cpu")
    start = {"tex_color_a": perturbed_start(scene)["tex_color_a"]}
    seen = []
    params, losses = fit_scene(
        scene, render_image(scene), params=start, settings=RenderSettings(),
        steps=25, callback=lambda i, loss: seen.append((i, loss)))
    assert losses[-1] < losses[0] * 0.25, losses[:3] + losses[-3:]
    assert seen == list(enumerate(losses))
    before = np.abs(start["tex_color_a"] - scene.tex_color_a.numpy()).max()
    after = (params["tex_color_a"] - scene.tex_color_a).abs().max()
    assert float(after) < before


def test_fit_checkpoint_resume(tmp_path):
    scene = make_test_scene(width=16, height=8, num_quads=2,
                            with_reflective=False, device="cpu")
    target = render_image(scene)
    start = {"tex_color_a": scene.tex_color_a + 0.2}
    ckpt = str(tmp_path / "ckpt")
    _, l1 = fit_scene(scene, target, params=dict(start), steps=6,
                      checkpoint_dir=ckpt, checkpoint_every=2)
    assert len(l1) == 6
    assert sorted(os.listdir(ckpt)) == ["step_3.pt", "step_5.pt"]
    # resume: continues from the saved step rather than restarting
    p2, l2 = fit_scene(scene, target, params=dict(start), steps=10,
                       checkpoint_dir=ckpt, checkpoint_every=5)
    assert len(l2) == 4, "resume should skip completed steps"
    assert np.isfinite(l2).all() and l2[0] < l1[-1]
    assert sorted(os.listdir(ckpt)) == ["step_5.pt", "step_9.pt"]
    # one uninterrupted fit takes the same ten steps (Adam state restored)
    p3, l3 = fit_scene(scene, target, params=dict(start), steps=10)
    np.testing.assert_allclose(l1 + l2, l3, rtol=1e-6)
    torch.testing.assert_close(p2["tex_color_a"], p3["tex_color_a"],
                               rtol=1e-6, atol=1e-7)


def test_defaults_optimizer_argument_and_mesh():
    scene = make_test_scene(width=16, height=8, num_quads=2, device="cpu")
    target = render_image(scene)
    assert sorted(default_trainable_params(scene)) == [
        "cam_position", "light_intensity", "tex_color_a", "tex_color_b",
        "vertices"]
    dim = scene.replace(light_intensity=scene.light_intensity * 0.5)
    params, losses = fit_scene(
        dim, target, steps=3,
        optimizer=lambda ps: torch.optim.SGD(ps, lr=1e-3))
    assert sorted(params) == sorted(default_trainable_params(scene))
    assert losses[2] < losses[1] < losses[0]
    assert not scene.vertices.requires_grad  # the scene itself is untouched
    loss = make_loss_fn(scene, RenderSettings(), target)(
        default_trainable_params(scene))
    assert float(loss) == 0.0
    # mesh= takes the row-sharded step; without a process group the mesh
    # is one device and the fit is the single-device one
    from crt_tpu_torch.parallel.sharded import make_mesh

    meshed, mesh_losses = fit_scene(
        dim, target, steps=3, mesh=make_mesh(),
        optimizer=lambda ps: torch.optim.SGD(ps, lr=1e-3))
    assert mesh_losses == pytest.approx(losses, rel=1e-6)
    for key, value in params.items():
        torch.testing.assert_close(meshed[key], value, rtol=0, atol=0)
