"""The CUDA kernels vs their plain versions, on the card.

Marked ``cuda``: these tests need an NVIDIA GPU and nvcc, and skip
elsewhere (the decision is taken inside a fixture, never at import).  This
file imports no JAX, so it also runs on a machine without it:

    python -m pytest tests/test_torch_cuda.py --noconftest -p no:xdist \
        -o addopts="" -q

Tolerance: the trace kernels EXACT.  They are built with -fmad=false and
without fast math and follow the plain versions' op order, so tri, t, rows
and masks must be bit-equal.  The segment-sum kernel adds f32 terms in
another order than ``index_add_`` (and, through atomics, in an order that
can change between runs), so it is held to an fp64 sum of the same terms:
|kernel - fp64| <= 4e-6 * (sum of |g| over the segment): ten times the
largest error read on an H100 (3.7e-7, on a 640,651-ray segment of a 1080p
frame) and a tenth of the worst case of its ~5 + 128 + R / 4096 sequential
f32 additions per segment at 2^-24 each, so a kernel that lost 1e-5 of a
segment's rays fails.  Against the plain version the limit is 5e-4 of the
same sum, four times the plain version's own distance from fp64 (1.3e-4
read there: one f32 atomic per term).
"""

import pytest
import torch

from crt_tpu_torch import RenderSettings, render_image
from crt_tpu_torch.ops import (
    binning,
    camera,
    cluster_tables,
    cluster_trace,
    segsum,
)
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
    scene = (make_big_scene(4096, 128, 96, device=device) if big
             else make_test_scene(192, 128, num_quads=24, device=device))
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
    scene = make_test_scene(192, 128, num_quads=24, device=device)
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
    scene = make_test_scene(96, 64, num_quads=16, with_edges=True,
                            device="cpu")
    cpu = render_image(scene)
    before = (cluster_trace.closest_hit_launches,
              cluster_trace.occlusion_w_launches)
    gpu = render_image(scene.to(device), RenderSettings()).cpu()
    after = (cluster_trace.closest_hit_launches,
             cluster_trace.occlusion_w_launches)
    assert after == (before[0] + 4, before[1] + 4)
    torch.testing.assert_close(gpu, cpu, rtol=1e-5, atol=1e-6)


def test_wrapper_rejects_mixed_devices(device):
    scene = make_test_scene(64, 32, num_quads=4, device="cpu")
    tables = cluster_tables.build_cluster_tables(scene)  # CPU tables
    o = torch.zeros((1024, 3), device=device)
    cl = torch.zeros((1, tables.n.shape[0]), dtype=torch.int32, device=device)
    cnt = torch.zeros((1,), dtype=torch.int32, device=device)
    with pytest.raises(ValueError):
        cluster_trace.closest_hit(tables, o, o, cl, cnt)


def _segsum_case(name, R, T, device):
    """Seeded ids [R] i32 on the card for one id pattern."""
    gen = torch.Generator().manual_seed(R + T)
    if name == "random":
        ids = torch.randint(-1, T, (R,), generator=gen)
    elif name == "banded":  # each 1024-ray tile draws from a 60-id window
        tiles = -(-R // 1024)
        lo = torch.randint(0, max(T - 60, 1), (tiles,), generator=gen)
        ids = (lo.repeat_interleave(1024)[:R]
               + torch.randint(0, 60, (R,), generator=gen)).clamp(max=T - 1)
        ids[::97] = -1
    elif name == "one_segment":  # every ray on one id: worst contention
        ids = torch.full((R,), T // 2)
    else:  # all misses
        ids = torch.full((R,), -1)
    return ids.to(torch.int32).to(device)


@pytest.mark.parametrize("K", [13, 22, 31])
@pytest.mark.parametrize("name", ["random", "banded", "one_segment",
                                  "all_miss"])
def test_segsum_kernel_matches_plain_and_fp64(device, name, K):
    R, T = 100_000 + 37, 700  # R is not a multiple of 1,024 (or of 32)
    ids = _segsum_case(name, R, T, device)
    gen = torch.Generator().manual_seed(K)
    g = torch.randn((K, R), generator=gen).to(device)
    before = segsum.segsum_launches
    out = segsum.segment_accumulate(ids, g, T)
    assert segsum.segsum_launches == before + 1
    torch.cuda.synchronize()
    assert out.shape == (K, T) and out.dtype == torch.float32
    plain = segsum.segment_accumulate_plain(ids, g, T)
    exact = segsum.segment_accumulate_plain(ids, g.double(), T)
    mass = segsum.segment_accumulate_plain(ids, g.double().abs(), T)
    assert bool(((out.double() - exact).abs() <= 4e-6 * mass).all())
    assert bool(((out - plain).abs().double() <= 5e-4 * mass).all())
    if name == "all_miss":
        assert not out.any()
    else:
        assert out.any()
    # a wide band (ids over 65,536 segments) takes the direct-atomics path
    wide = _segsum_case("random", 20_000, 65_536, device)
    out = segsum.segment_accumulate(wide, g[:, :20_000].contiguous(), 65_536)
    exact = segsum.segment_accumulate_plain(
        wide, g[:, :20_000].double(), 65_536)
    torch.testing.assert_close(out.double(), exact, rtol=1e-6, atol=1e-6)


def test_grads_on_card_match_cpu(device):
    """Six parameter groups through the card (kernels, K3 in the backward)
    vs the CPU (plain versions).  The hit ids are bit-equal; shading ops
    round an ulp apart on the two devices and the per-pixel terms of a
    vertex gradient, which largely cancel, are summed in the kernel's tree
    order there and one by one here: rtol 1e-4, atol 2e-4 of the group's
    largest entry (5e-5 observed on the vertices, 2e-7 on the others)."""
    groups = ("vertices", "light_intensity", "light_position", "tex_color_a",
              "cam_position", "cam_rotation")
    grads = {}
    for dev in ("cpu", device):
        scene = make_test_scene(96, 64, num_quads=16, with_edges=True,
                                device=dev)
        params = {k: getattr(scene, k).clone().requires_grad_(True)
                  for k in groups}
        before = segsum.segsum_launches
        img = render_image(scene.replace(**params))
        (img * img).sum().backward()
        launched = segsum.segsum_launches - before
        # per shading level: the packed rows and the tex_color_a rows
        assert launched == (0 if dev == "cpu" else 8)
        grads[str(dev)] = {k: p.grad.cpu() for k, p in params.items()}
    for k in groups:
        want = grads["cpu"][k]
        assert bool(torch.isfinite(grads[str(device)][k]).all()), k
        torch.testing.assert_close(
            grads[str(device)][k], want, rtol=1e-4,
            atol=2e-4 * float(want.abs().max()),
            msg=lambda m, k=k: f"{k}: {m}")


@pytest.mark.parametrize("fault", ["dtype", "device", "layout"])
def test_segsum_wrapper_rejects(device, fault):
    g = torch.zeros((13, 2048), device=device)
    ids = torch.zeros((2048,), dtype=torch.int32, device=device)
    if fault == "dtype":
        g = g.half()
    elif fault == "device":
        ids = ids.cpu()
    else:
        g = torch.zeros((2048, 13), device=device).T
    before = segsum.segsum_launches
    with pytest.raises(ValueError):
        segsum.segment_accumulate(ids, g, 66)
    assert segsum.segsum_launches == before
