"""The frozen roofline against chip_smoke.py's arithmetic and the port's
partition and binning as they stood when the copy was made."""

import torch

import bench_setup  # noqa: F401  (the import path)

from harness import roofline as rf
from harness import scenes


def test_constants_and_bound_equal_chip_smokes():
    import chip_smoke as cs

    assert rf.H100_BYTES_PER_S == cs.H100_BYTES_PER_S
    assert rf.H100_FP32_FLOPS == cs.H100_FP32_FLOPS
    assert rf.FLOPS_PER_MEMBER == cs.FLOPS_PER_MEMBER
    for by, fl in ((3.35e9, 1e9), (1e6, 6.7e12), (0, 0), (7e10, 1e12)):
        assert rf.bound_ms(by, fl) == cs.bound_ms(by, fl)


def _port_scene(n_quads=64, side=64):
    cfg = {"kind": "quads", "width": side, "height": side,
           "num_quads": n_quads, "layout_seed": 0}
    desc = scenes.quads_description(cfg)
    return desc, scenes.program_scene("quads", desc, "cpu")


def test_partition_equals_the_ports():
    from crt_tpu_torch.ops.cluster_tables import build_cluster_tables
    from crt_tpu_torch.scene.procedural import make_big_scene

    for sc in (_port_scene()[1],
               make_big_scene(5000, 64, 64, build_accel=False, device="cpu")):
        t = build_cluster_tables(sc)
        lo, hi, members = rf.cluster_boxes(sc.vertices, sc.tri_vidx)
        assert torch.equal(lo, t.cl_min) and torch.equal(hi, t.cl_max)
        assert torch.equal(members, (t.tri_id >= 0).sum(dim=1))


def test_member_tests_equal_the_ports_lists():
    from crt_tpu_torch.ops import camera
    from crt_tpu_torch.ops.binning import bin_rays
    from crt_tpu_torch.ops.cluster_tables import build_cluster_tables
    from crt_tpu_torch.renderer import make_tiler
    from crt_tpu_torch.scene.procedural import make_big_scene

    for sc in (_port_scene()[1],
               make_big_scene(20000, 64, 64, build_accel=False, device="cpu")):
        W = H = 64
        rx, ry, _ = make_tiler(H, W, device="cpu")
        o, d = camera.generate_rays(sc.cam_position, sc.cam_rotation,
                                    sc.cam_tan_half_fov, W, H, rx, ry)
        t = build_cluster_tables(sc)
        cl, cnt = bin_rays(t, o.contiguous(), d, 1024)
        members = (t.tri_id >= 0).sum(dim=1)
        on = torch.arange(cl.shape[1])[None] < cnt[:, None]
        port_tests = int(((members[cl.long()] * on).sum(dim=1) * 1024).sum())
        # the frozen count from the rays in image layout
        oi, di = camera.generate_rays(sc.cam_position, sc.cam_rotation,
                                      sc.cam_tan_half_fov, W, H)
        b = rf.primary_hit_bound(sc.vertices, sc.tri_vidx,
                                 oi.contiguous(), di, W, H)
        assert b["member_tests"] == port_tests > 0
        assert b["bound_ms"] > 0
