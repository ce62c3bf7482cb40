"""The CUDA kernels vs their plain versions, on the card.

Marked ``cuda``: these tests need an NVIDIA GPU and nvcc, and skip
elsewhere (the decision is taken inside a fixture, never at import).  This
file imports no JAX, so it also runs on a machine without it:

    python -m pytest tests/test_torch_cuda.py --noconftest -p no:xdist \
        -o addopts="" -q

Tolerance: EXACT.  The kernels are built with -fmad=false and without fast
math and follow the plain versions' op order, so tri, t, rows and masks
must be bit-equal.
"""

import pytest
import torch

from crt_tpu_torch import RenderSettings, render_image
from crt_tpu_torch.ops import binning, camera, cluster_tables, cluster_trace
from crt_tpu_torch.renderer import make_tiler
from crt_tpu_torch.scene.procedural import make_big_scene, make_test_scene

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


def _wavefront(scene):
    rx, ry, _ = make_tiler(scene.height, scene.width, device=scene.device)
    o, d = camera.generate_rays(scene.cam_position, scene.cam_rotation,
                                scene.cam_tan_half_fov, scene.width,
                                scene.height, rx, ry)
    return o.contiguous(), d.contiguous()


@pytest.mark.parametrize("big", [False, True])
def test_closest_hit_kernel_matches_plain(device, big):
    scene = (make_big_scene(4096, 128, 96) if big
             else make_test_scene(192, 128, num_quads=24)).to(device)
    tables = cluster_tables.build_cluster_tables(scene)
    rows_table = cluster_tables.emit_rows_table(scene, tables)
    o, d = _wavefront(scene)
    act = torch.arange(o.shape[0], device=device) % 3 != 0
    cl, cnt = binning.bin_rays(tables, o, d, 1024, act)
    before = cluster_trace.closest_hit_launches
    k = cluster_trace.closest_hit(tables, o, d, cl, cnt, rows_table)
    assert cluster_trace.closest_hit_launches == before + 1
    p = cluster_trace.closest_hit_plain(tables, o, d, cl, cnt, rows_table)
    torch.cuda.synchronize()
    assert torch.equal(k[1], p[1])
    assert torch.equal(k[0], p[0])
    assert torch.equal(k[2], p[2])
    assert (k[1] >= 0).any()


def test_occlusion_w_kernel_matches_plain(device):
    scene = make_test_scene(192, 128, num_quads=24).to(device)
    tables = cluster_tables.build_cluster_tables(scene)
    o, d = _wavefront(scene)
    t, tri, _ = cluster_trace.closest_hit(
        tables, o, d, *binning.bin_rays(tables, o, d, 1024))
    valid = tri >= 0
    point = (o + d * torch.where(valid, t, 0.0)[:, None]).contiguous()
    shadow_o = (point + 0.01 * torch.tensor([0.0, 1.0, 0.0],
                                            device=device)).contiguous()
    lights = scene.light_position.contiguous()
    act = torch.stack([valid, valid & (point[:, 0] > 0)])
    cl, cnt = binning.bin_apex_shared(tables, shadow_o, lights, act, 1024,
                                      0.02)
    before = cluster_trace.occlusion_w_launches
    k = cluster_trace.occlusion_w(tables, shadow_o, point, lights, cl, cnt)
    assert cluster_trace.occlusion_w_launches == before + 1
    p = cluster_trace.occlusion_w_plain(tables, shadow_o, point, lights, cl,
                                        cnt)
    torch.cuda.synchronize()
    assert torch.equal(k, p)
    assert k.any() and not k.all()


def test_render_on_card_matches_cpu(device):
    """The card render (kernels) vs the CPU render (plain versions): the
    trace is bit-equal, the shading ops may round differently on the two
    devices (rtol 1e-5 / atol 1e-6, test_pallas_trace.py's tolerance)."""
    scene = make_test_scene(96, 64, num_quads=16, with_edges=True)
    cpu = render_image(scene)
    before = (cluster_trace.closest_hit_launches,
              cluster_trace.occlusion_w_launches)
    gpu = render_image(scene.to(device), RenderSettings()).cpu()
    after = (cluster_trace.closest_hit_launches,
             cluster_trace.occlusion_w_launches)
    assert after == (before[0] + 4, before[1] + 4)
    torch.testing.assert_close(gpu, cpu, rtol=1e-5, atol=1e-6)


def test_wrapper_rejects_mixed_devices(device):
    scene = make_test_scene(64, 32, num_quads=4)
    tables = cluster_tables.build_cluster_tables(scene)  # CPU tables
    o = torch.zeros((1024, 3), device=device)
    cl = torch.zeros((1, tables.n.shape[0]), dtype=torch.int32, device=device)
    cnt = torch.zeros((1,), dtype=torch.int32, device=device)
    with pytest.raises(ValueError):
        cluster_trace.closest_hit(tables, o, o, cl, cnt)
