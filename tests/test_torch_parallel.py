"""crt_tpu_torch.parallel vs crt_tpu.parallel, on gloo ranks on the CPU.

The port's side runs in 2 or 4 processes that this file spawns (it is
also their script: ``python tests/test_torch_parallel.py CASES RANK WORLD
DIR DEVICE``), joined in one gloo process group through a file store in
the test's temporary directory, so no TCP port is taken.  Each rank pins
torch to one thread; the ranks are killed and the test fails if they run
past their time limit.  A rank saves what each case returns; the tests
hold rank 0's to crt_tpu's sharded functions, run here on the virtual CPU
devices of tests/conftest.py (a 1-D mesh of 2, a 2-D mesh of 2 x 2), and
every rank's frame to rank 0's.

Tolerances: images rtol 1e-5 / atol 1e-6 (the refractive one atol 1e-5),
as tests/test_sharding.py and tests/test_scene_sharded.py hold crt_tpu's
own sharded images; gradients rtol 5e-4 / atol 1e-6 (rtol 1e-3 on the
iterative refractive case), their tolerances for the sharded gradients.
"""

import datetime
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from torch_port_fixtures import _one_torch_thread, _release_heap  # noqa: F401

RANK_TIMEOUT = 420  # seconds for one launch of ranks, all cases together

ROWS = dict(width=40, height=32, num_quads=5)
ROWS_ODD = dict(width=16, height=31, num_quads=3)  # 31 rows over 2 ranks
GRAD = dict(width=40, height=32, num_quads=5, with_edges=True)
FIT = dict(width=16, height=16, num_quads=4)
# the parameters one step of the FIT fit moves (the scene has no edges
# texture, so tex_color_b gets no gradient)
FIT_MOVED = ("vertices", "tex_color_a", "light_intensity", "cam_position")
MULTI = dict(width=48, height=32, num_quads=5)
SCENE = dict(width=40, height=24, num_quads=7, with_reflective=True)
# 3 quads: 5 triangles in one cluster, so the second shard holds only pad
SCENE_ODD = dict(width=16, height=8, num_quads=3, with_reflective=False)
SMOOTH = dict(width=32, height=16, num_quads=5, with_reflective=True)
STREAM = dict(width=32, height=16, num_quads=300, with_reflective=False)
STREAM_KW = dict(local_backend="pallas_stream", sc_clusters=4,
                 stream_tile_rays=256)
REFRACT = dict(width=32, height=16, num_quads=5, with_refractive=True)


# ---------------------------------------------------------------------------
# The ranks' side (imports no JAX)
# ---------------------------------------------------------------------------

def _scene(device, **kw):
    from crt_tpu_torch.scene.procedural import make_test_scene

    return make_test_scene(**kw, device=device)


def _case_rows(device):
    from crt_tpu_torch.parallel.sharded import render_image_sharded

    return {name: render_image_sharded(_scene(device, **kw))
            for name, kw in (("even", ROWS), ("odd", ROWS_ODD))}


def _case_rows_grad(device):
    from crt_tpu_torch import render_image
    from crt_tpu_torch.parallel.sharded import sharded_value_and_grad

    scene = _scene(device, **GRAD)
    loss, grads = sharded_value_and_grad(scene, render_image(scene) + 0.05)
    return {"loss": loss, "grads": grads}


def _fit_target(scene):
    from crt_tpu_torch import render_image

    return render_image(scene.replace(
        light_intensity=scene.light_intensity * 1.3))


def _case_fit(device):
    from crt_tpu_torch import fit_scene
    from crt_tpu_torch.parallel.sharded import make_mesh

    scene = _scene(device, **FIT)
    target = _fit_target(scene)

    def sgd(ps):
        return torch.optim.SGD(ps, lr=1.0)

    mesh_sgd, _ = fit_scene(scene, target, optimizer=sgd, steps=1,
                            mesh=make_mesh())
    one_sgd, _ = fit_scene(scene, target, optimizer=sgd, steps=1)
    mesh_adam, losses = fit_scene(scene, target, steps=2, mesh=make_mesh())
    return {"mesh_sgd": mesh_sgd, "one_sgd": one_sgd,
            "mesh_adam": mesh_adam, "adam_losses": losses}


def _case_multihost(device):
    from crt_tpu_torch.parallel import multihost

    return {"frame": multihost.render_image_multihost(
        _scene(device, **MULTI))}


def _case_rows_card(device):
    from crt_tpu_torch import render_image
    from crt_tpu_torch.parallel.sharded import render_image_sharded

    scene = _scene(device, **ROWS_ODD)
    return {"sharded": render_image_sharded(scene),
            "single": render_image(scene)}


def _mesh2d():
    from crt_tpu_torch.parallel.sharded import make_mesh

    return make_mesh((2, 2), ("rays", "scene"))


def _case_scene(device):
    from crt_tpu_torch import RenderSettings
    from crt_tpu_torch.parallel.scene_sharded import (
        build_partitioned_tables,
        render_image_scene_sharded,
    )

    mesh = _mesh2d()
    out = {}
    for name, kw in (("scene", SCENE), ("odd", SCENE_ODD),
                     ("smooth", SMOOTH)):
        out[name] = render_image_scene_sharded(_scene(device, **kw),
                                               RenderSettings(), mesh)
    out["stream"] = render_image_scene_sharded(
        _scene(device, **STREAM), RenderSettings(), mesh, **STREAM_KW)
    out["refract"] = render_image_scene_sharded(
        _scene(device, **REFRACT), RenderSettings(max_ray_depth=2), mesh)
    tables, packed, shard_tris = build_partitioned_tables(
        _scene(device, **STREAM), mesh, "scene")
    out["shard"] = {"tables": tables._asdict(), "packed": packed,
                    "shard_tris": shard_tris}
    return out


def _case_scene_grad(device):
    from crt_tpu_torch import RenderSettings, render_image
    from crt_tpu_torch.parallel.scene_sharded import (
        scene_sharded_value_and_grad,
    )

    mesh = _mesh2d()
    bf = RenderSettings(backend="bruteforce")
    out = {}
    scene = _scene(device, **SMOOTH)
    target = render_image(scene, bf) + 0.03
    out["grad"] = scene_sharded_value_and_grad(scene, target, mesh=mesh)
    out["stream"] = scene_sharded_value_and_grad(scene, target, mesh=mesh,
                                                 **STREAM_KW)
    glass = _scene(device, **REFRACT)
    st = RenderSettings(max_ray_depth=2)
    target = render_image(glass, bf.replace(max_ray_depth=2)) + 0.03
    out["refract"] = scene_sharded_value_and_grad(
        glass, target,
        params={"vertices": glass.vertices,
                "light_intensity": glass.light_intensity},
        settings=st, mesh=mesh)
    return out


CASES = {
    "rows": _case_rows,
    "rows_grad": _case_rows_grad,
    "fit": _case_fit,
    "multihost": _case_multihost,
    "rows_card": _case_rows_card,
    "scene": _case_scene,
    "scene_grad": _case_scene_grad,
}


def _rank_main(cases, rank, world, out_dir, device, table=None):
    """One rank: run ``cases`` of ``table`` (default ``CASES``) and save
    what they return."""
    import torch.distributed as dist

    from crt_tpu_torch.parallel import multihost

    table = CASES if table is None else table
    torch.set_num_threads(1)
    assert multihost.initialize(
        init_method=f"file://{out_dir}/store", world_size=world, rank=rank,
        backend="gloo", timeout=datetime.timedelta(seconds=RANK_TIMEOUT))
    results = {case: table[case](device) for case in cases}
    torch.save(_to_cpu(results), os.path.join(out_dir, f"rank{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


def _to_cpu(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu()
    if isinstance(x, np.ndarray):
        return torch.from_numpy(x)
    if isinstance(x, dict):
        return {k: _to_cpu(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_to_cpu(v) for v in x)
    return x


def launch_ranks(out_dir, cases, world, device="cpu", timeout=RANK_TIMEOUT,
                 script=__file__):
    """Run ``cases`` on ``world`` gloo ranks -> each rank's results.  The
    ranks are killed, and the calling test fails, past ``timeout``
    seconds.  ``script`` is the ranks' script (this file, or another whose
    main passes its own case table to ``_rank_main``)."""
    os.makedirs(out_dir, exist_ok=True)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(script), ",".join(cases),
         str(rank), str(world), str(out_dir), device],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for rank in range(world)]
    deadline = time.monotonic() + timeout
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(
                timeout=max(1.0, deadline - time.monotonic()))[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        for p in procs:
            p.communicate()
        pytest.fail(f"gloo ranks still running after {timeout} s")
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} exited {p.returncode}:\n" \
            + out[-6000:]
    return [torch.load(os.path.join(out_dir, f"rank{r}.pt"))
            for r in range(world)]


# ---------------------------------------------------------------------------
# The tests (crt_tpu in this process)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def rows_ranks(tmp_path_factory):
    return launch_ranks(tmp_path_factory.mktemp("rows"),
                        ["rows", "rows_grad", "fit", "multihost"], 2)


@pytest.fixture(scope="module")
def scene_ranks(tmp_path_factory):
    return launch_ranks(tmp_path_factory.mktemp("scene"),
                        ["scene", "scene_grad"], 4)


@pytest.fixture(scope="module")
def jmesh():
    import jax

    from crt_tpu.parallel.sharded import make_mesh

    return make_mesh(jax.devices()[:2])


@pytest.fixture(scope="module")
def jmesh2d():
    import jax
    from jax.sharding import Mesh

    return Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("rays", "scene"))


def _jscene(**kw):
    from crt_tpu.scene.procedural import make_test_scene

    return make_test_scene(**kw)


def _same_on_every_rank(ranks, *keys):
    def pick(r):
        for k in keys:
            r = r[k]
        return r

    for r in ranks[1:]:
        torch.testing.assert_close(pick(r), pick(ranks[0]), rtol=0, atol=0)
    return pick(ranks[0]).numpy()


@pytest.mark.parametrize("name,kw", [("even", ROWS), ("odd", ROWS_ODD)])
def test_row_sharded_frame_matches_crt_tpu(rows_ranks, jmesh, name, kw):
    from crt_tpu import RenderSettings
    from crt_tpu.parallel.sharded import render_image_sharded

    img = _same_on_every_rank(rows_ranks, "rows", name)
    ref = np.asarray(render_image_sharded(_jscene(**kw), RenderSettings(),
                                          jmesh))
    assert img.shape == ref.shape == (kw["height"], kw["width"], 3)
    np.testing.assert_allclose(img, ref, rtol=1e-5, atol=1e-6)


def test_row_sharded_grads_match_crt_tpu(rows_ranks, jmesh):
    from crt_tpu import RenderSettings, render_image
    from crt_tpu.parallel.sharded import (
        default_trainable_params,
        sharded_value_and_grad,
    )

    scene = _jscene(**GRAD)
    target = render_image(scene, RenderSettings()) + 0.05
    loss, grads = sharded_value_and_grad(
        scene, target, default_trainable_params(scene), RenderSettings(),
        jmesh)
    got = rows_ranks[0]["rows_grad"]
    np.testing.assert_allclose(float(got["loss"]), float(loss), rtol=1e-4)
    for key, g in grads.items():
        _same_on_every_rank(rows_ranks, "rows_grad", "grads", key)
        np.testing.assert_allclose(got["grads"][key].numpy(), np.asarray(g),
                                   rtol=5e-4, atol=1e-6, err_msg=key)
        assert np.abs(np.asarray(g)).max() > 0, key


def test_sharded_fit_sgd_step_is_the_single_device_step(rows_ranks):
    """The port's mesh= step equals its single-device step."""
    got = rows_ranks[0]["fit"]
    scene = _scene("cpu", **FIT)
    for key, one in got["one_sgd"].items():
        start = getattr(scene, key)
        step_one = one - start
        step_mesh = got["mesh_sgd"][key] - start
        if key in FIT_MOVED:
            assert float(step_one.abs().max()) > 0, key
        # the steps are differences of f32 parameters: an ulp of the start
        torch.testing.assert_close(
            step_mesh, step_one, rtol=1e-4,
            atol=1e-6 * max(1.0, float(start.abs().max())), msg=key)


def test_crt_tpu_sharded_fit_takes_the_mesh_size_times_the_step(jmesh):
    """crt_tpu's fit_scene(mesh=) psums gradients that AD has already
    all-reduced: under plain SGD its step is 2x the single-device step on
    a mesh of 2.  The port does not carry this (the test above)."""
    import jax.numpy as jnp
    import optax

    from crt_tpu import RenderSettings, render_image
    from crt_tpu.optim import fit_scene

    scene = _jscene(**FIT)
    target = render_image(scene.replace(
        light_intensity=scene.light_intensity * 1.3), RenderSettings())
    mesh_p, _ = fit_scene(scene, target, optimizer=optax.sgd(1.0), steps=1,
                          mesh=jmesh)
    one_p, _ = fit_scene(scene, target, optimizer=optax.sgd(1.0), steps=1)
    for key in FIT_MOVED:
        start = jnp.asarray(getattr(scene, key))
        step_one = np.asarray(one_p[key] - start)
        step_mesh = np.asarray(mesh_p[key] - start)
        assert np.abs(step_one).max() > 0, key
        np.testing.assert_allclose(
            step_mesh, 2.0 * step_one, rtol=1e-4,
            atol=1e-6 * max(1.0, float(jnp.abs(start).max())), err_msg=key)


def test_sharded_fit_adam_close_to_crt_tpu(rows_ranks, jmesh):
    """Under Adam a step is lr * m / (sqrt(v) + eps): crt_tpu's 2x
    gradient moves it only through eps (1e-8), so the two fits agree."""
    from crt_tpu import RenderSettings, render_image
    from crt_tpu.optim import fit_scene

    scene = _jscene(**FIT)
    target = render_image(scene.replace(
        light_intensity=scene.light_intensity * 1.3), RenderSettings())
    ref, losses = fit_scene(scene, target, steps=2, mesh=jmesh)
    got = rows_ranks[0]["fit"]
    np.testing.assert_allclose(got["adam_losses"], losses, rtol=1e-4)
    for key, v in ref.items():
        np.testing.assert_allclose(got["mesh_adam"][key].numpy(),
                                   np.asarray(v), rtol=1e-4, atol=1e-4,
                                   err_msg=key)


def test_two_process_multihost_render(rows_ranks):
    from crt_tpu import RenderSettings, render_image

    frame = _same_on_every_rank(rows_ranks, "multihost", "frame")
    ref = np.asarray(render_image(_jscene(**MULTI), RenderSettings()))
    np.testing.assert_allclose(frame, ref, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name,kw,extra", [
    ("scene", SCENE, {}),
    ("odd", SCENE_ODD, {}),
    ("smooth", SMOOTH, {}),
    ("stream", STREAM, STREAM_KW),
])
def test_scene_partitioned_frame_matches_crt_tpu(scene_ranks, jmesh2d, name,
                                                 kw, extra):
    from crt_tpu import RenderSettings
    from crt_tpu.parallel.scene_sharded import render_image_scene_sharded

    img = _same_on_every_rank(scene_ranks, "scene", name)
    ref = np.asarray(render_image_scene_sharded(
        _jscene(**kw), RenderSettings(), jmesh2d, **extra))
    np.testing.assert_allclose(img, ref, rtol=1e-5, atol=1e-6)


def test_refractive_partitioned_frame_matches_crt_tpu(scene_ranks, jmesh2d):
    from crt_tpu import RenderSettings
    from crt_tpu.parallel.scene_sharded import render_image_scene_sharded

    img = _same_on_every_rank(scene_ranks, "scene", "refract")
    ref = np.asarray(render_image_scene_sharded(
        _jscene(**REFRACT), RenderSettings(max_ray_depth=2), jmesh2d))
    np.testing.assert_allclose(img, ref, rtol=1e-5, atol=1e-5)


def test_partitioned_tables_are_the_shards_of_the_whole(scene_ranks):
    """Each scene rank builds its own block of clusters (and holds 1/N of
    the packed table): they equal the slices of the whole scene's tables,
    padded, and each shard's rank map is its own."""
    from crt_tpu_torch.ops.cluster_tables import CLUSTER_SIZE
    from crt_tpu_torch.ops.cluster_tables import build_cluster_tables
    from crt_tpu_torch.ops.shade import build_packed
    from crt_tpu_torch.parallel.scene_sharded import pad_tables_for_shards

    scene = _scene("cpu", **STREAM)
    full = pad_tables_for_shards(build_cluster_tables(scene), 2)
    packed = build_packed(scene)
    per = full.n.shape[0] // 2
    assert per < full.n.shape[0]
    for rank, r in enumerate(scene_ranks):
        k = rank % 2  # the scene axis is the mesh's second
        shard = r["scene"]["shard"]
        tables = shard["tables"]
        for name, x in full._asdict().items():
            if name == "rank":
                continue
            torch.testing.assert_close(tables[name],
                                       x[k * per:(k + 1) * per],
                                       rtol=0, atol=0, msg=name)
        own = (full.rank >= k * per * CLUSTER_SIZE) \
            & (full.rank < (k + 1) * per * CLUSTER_SIZE)
        torch.testing.assert_close(
            tables["rank"], torch.where(own, full.rank - k * per
                                        * CLUSTER_SIZE, -1))
        st = shard["shard_tris"]
        assert st == -(-packed.shape[1] // 2)
        want = packed[:, k * st:(k + 1) * st]
        torch.testing.assert_close(shard["packed"][:, :want.shape[1]], want,
                                   rtol=0, atol=0)


@pytest.mark.parametrize("case", ["grad", "stream", "refract"])
def test_scene_partitioned_grads_match_crt_tpu(scene_ranks, jmesh2d, case):
    import jax.numpy as jnp

    from crt_tpu import RenderSettings, render_image
    from crt_tpu.parallel.scene_sharded import scene_sharded_value_and_grad
    from crt_tpu.parallel.sharded import default_trainable_params

    bf = RenderSettings(backend="bruteforce")
    kw, settings, rtol = dict(), RenderSettings(), 5e-4
    if case == "refract":
        scene = _jscene(**REFRACT)
        settings = RenderSettings(max_ray_depth=2)
        target = jnp.asarray(render_image(scene, bf.replace(
            max_ray_depth=2))) + 0.03
        params = {"vertices": scene.vertices,
                  "light_intensity": scene.light_intensity}
        rtol = 1e-3
    else:
        scene = _jscene(**SMOOTH)
        target = jnp.asarray(render_image(scene, bf)) + 0.03
        params = default_trainable_params(scene)
        if case == "stream":
            kw = STREAM_KW
    loss, grads = scene_sharded_value_and_grad(
        scene, target, params=params, settings=settings, mesh=jmesh2d, **kw)
    got_loss, got = scene_ranks[0]["scene_grad"][case]
    np.testing.assert_allclose(float(got_loss), float(loss), rtol=1e-4)
    for key, g in grads.items():
        _same_on_every_rank(scene_ranks, "scene_grad", case, 1, key)
        np.testing.assert_allclose(got[key].numpy(), np.asarray(g),
                                   rtol=rtol, atol=1e-6, err_msg=key)
    assert max(float(np.abs(np.asarray(g)).max())
               for g in grads.values()) > 0


def test_one_process_functions_are_a_one_device_mesh(monkeypatch):
    """Without a process group every function runs as a one-device mesh
    and equals the single-device render and gradient bit for bit."""
    from crt_tpu_torch import RenderSettings, render_image
    from crt_tpu_torch.optim import make_loss_fn
    from crt_tpu_torch.parallel import multihost
    from crt_tpu_torch.parallel.scene_sharded import (
        render_image_scene_sharded,
    )
    from crt_tpu_torch.parallel.sharded import (
        default_trainable_params,
        make_mesh,
        render_image_sharded,
        sharded_value_and_grad,
    )

    monkeypatch.delenv("MASTER_ADDR", raising=False)
    assert not torch.distributed.is_initialized()
    assert multihost.initialize() is False
    scene = _scene("cpu", **ROWS)
    img = render_image(scene)
    torch.testing.assert_close(render_image_sharded(scene, mesh=make_mesh()),
                               img, rtol=0, atol=0)
    torch.testing.assert_close(render_image_scene_sharded(scene), img,
                               rtol=0, atol=0)
    target = img + 0.05
    loss, grads = sharded_value_and_grad(scene, target)
    params = {k: v.clone().requires_grad_(True)
              for k, v in default_trainable_params(scene).items()}
    ref = make_loss_fn(scene, RenderSettings(), target)(params)
    ref.backward()
    torch.testing.assert_close(loss, ref.detach(), rtol=1e-6, atol=0)
    for k, p in params.items():
        want = p.grad if p.grad is not None else torch.zeros_like(p)
        torch.testing.assert_close(grads[k], want, rtol=1e-5, atol=1e-7)


def test_fault_injection_redispatch_bit_identical():
    """A block's first attempt is lost; the scheduler re-dispatches it and
    the frame equals the straight render bit for bit."""
    from crt_tpu_torch import render_image
    from crt_tpu_torch.parallel import multihost

    scene = _scene("cpu", width=32, height=24, num_quads=4)
    full = render_image(scene).numpy()
    calls = {"n": 0, "failed": []}

    def flaky_block(s, start, n, st):
        calls["n"] += 1
        if start == 12 and 12 not in calls["failed"]:
            calls["failed"].append(12)
            raise ConnectionError("host of block 12 went away")
        return multihost.render_rows_local(s, start, n, st)

    frame = multihost.render_blocks_with_recovery(
        scene, num_blocks=4, render_block=flaky_block)
    assert calls["failed"] == [12]
    assert calls["n"] == 5  # 4 blocks + 1 re-dispatch
    np.testing.assert_array_equal(frame, full)


def test_block_exhausts_retries_raises():
    from crt_tpu_torch.parallel import multihost

    scene = _scene("cpu", width=16, height=8, num_quads=2)

    def always_fails(s, start, n, st):
        raise ConnectionError("dead host")

    with pytest.raises(multihost.BlockRenderError):
        multihost.render_blocks_with_recovery(
            scene, num_blocks=2, render_block=always_fails, max_attempts=2)


def test_render_rows_local_matches_crt_tpu():
    from crt_tpu import RenderSettings
    from crt_tpu.parallel import multihost as jmultihost
    from crt_tpu_torch.parallel import multihost

    kw = dict(width=32, height=16, num_quads=4)
    block = multihost.render_rows_local(_scene("cpu", **kw), 4, 6)
    ref = np.asarray(jmultihost.render_rows_local(_jscene(**kw), 4, 6,
                                                  RenderSettings()))
    np.testing.assert_allclose(block.numpy(), ref, rtol=1e-5, atol=1e-6)


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))))
    _rank_main(sys.argv[1].split(","), int(sys.argv[2]), int(sys.argv[3]),
               sys.argv[4], sys.argv[5])
