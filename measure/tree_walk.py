"""Time the tree backend's walk (``crt_tpu_torch/ops/traverse.py``) by how
often it reads its loop condition, and against the dense walk of
crt_tpu's structure, in turns.

    python3 measure/tree_walk.py [--phases]

Shapes (chip_smoke.py's scenes): the opaque benchmark frame's primary
wavefront, its depth-0 shadow wavefront (two lights stacked, recorded
from a real frame with its active mask), the 65,536-triangle primary, and
the whole forward tree frame.  For each: the walk as shipped at
``CHECK_EVERY`` = 1, 2, 4 and 8 (host clock around a synchronize, median
of 3; the values in turns, ascending then descending), and the dense walk
of crt_tpu's ``lax.while_loop`` body (every live lane through the leaf
test each iteration, the condition read every 4 iterations), each walk
held bit-equal to the shipped walk at its default.  ``--phases`` then runs
chip_smoke.py's ``[tree]`` and ``[utils]`` phases.

Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import pathlib
import statistics
import sys
import time

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from crt_tpu_torch.ops import traverse  # noqa: E402
from crt_tpu_torch.utils import trace as tracing  # noqa: E402
from crt_tpu_torch.ops.intersect import Hit  # noqa: E402

KS = (1, 2, 4, 8)


def dense_walk(accel, tri, origins, dirs, active=None, check_every=4):
    """crt_tpu's walk: every lane through the whole body, the leaf test
    included, each iteration (inactive lanes start with an empty stack);
    the condition read every ``check_every`` iterations -> (Hit,
    iterations)."""
    o, d = origins.reshape(-1, 3), dirs.reshape(-1, 3)
    R, dev = o.shape[0], o.device
    nodes_f = torch.cat([accel.node_min, accel.node_max], dim=1)
    nodes_i = torch.cat([accel.node_children, accel.node_leaf_id[:, None]], 1)
    stack = torch.zeros((R, traverse.STACK_SIZE), dtype=torch.int32,
                        device=dev)
    sp = (torch.ones((R,), dtype=torch.int32, device=dev) if active is None
          else active.reshape(-1).to(torch.int32))
    best_t = torch.full((R,), float("inf"), device=dev)
    best_tri = torch.full((R,), -1, dtype=torch.int32, device=dev)
    iterations = 0
    with torch.no_grad():
        inv = traverse._inverse(d)
        while bool((sp > 0).any()):
            for _ in range(check_every):
                act = sp > 0
                top = (sp - 1).clamp(min=0)
                node = torch.where(act, stack.gather(1, top[:, None].long())
                                   [:, 0], torch.zeros_like(top)).long()
                sp = torch.where(act, sp - 1, sp)
                box = nodes_f[node]
                hit_box = act & traverse._ray_aabb(o, inv, box[:, 0:3],
                                                   box[:, 3:6])
                ni = nodes_i[node]
                is_leaf = ni[:, 2] >= 0
                ids = torch.where((hit_box & is_leaf)[:, None],
                                  accel.leaf_tris[ni[:, 2].clamp(min=0)
                                                  .long()],
                                  torch.full_like(accel.leaf_tris[:1], -1))
                best_t, best_tri = traverse._leaf_intersect(
                    tri, ids, o, d, best_t, best_tri)
                descend = hit_box & ~is_leaf
                for k in (0, 1):
                    ck = ni[:, k]
                    push = descend & (ck >= 0)
                    pos = torch.where(push, sp, torch.zeros_like(sp))[:, None]
                    cur = stack.gather(1, pos.long())
                    stack.scatter_(1, pos.long(),
                                   torch.where(push[:, None], ck[:, None],
                                               cur))
                    sp = sp + push.to(torch.int32)
                iterations += 1
    shape = origins.shape[:-1]
    return Hit(t=best_t.reshape(shape), tri=best_tri.reshape(shape)), \
        iterations


def wall_ms(fn, reps=3) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def shapes(device):
    """name -> (accel, tri, o, d, active) and the scenes."""
    from crt_tpu_torch import RenderSettings, render_image
    from crt_tpu_torch.scene.procedural import make_big_scene, make_test_scene

    scene = make_test_scene(**cs.BENCH, device=device)
    big = make_big_scene(**cs.MID, device=device)
    out = {}
    for name, sc in (("opaque primary", scene),
                     ("65,536-triangle primary", big)):
        o, d = cs.primary_wavefront(sc)
        tri = traverse.build_triangle_gather(
            sc.vertices, sc.tri_vidx,
            sc.mat_backface[sc.tri_material.long()])
        out[name] = (sc.accel, tri, o, d, None)
    seen = []
    real = traverse.closest_hit_tree

    def record(accel, tri, o, d, active=None):
        seen.append((accel, tri, o, d, active))
        return real(accel, tri, o, d, active)

    traverse.closest_hit_tree = record
    try:
        render_image(scene, RenderSettings(backend="tree"))
    finally:
        traverse.closest_hit_tree = real
    # the depth-0 shadow pass: the masked walk with the most live lanes
    shadow = max((w for w in seen if w[4] is not None),
                 key=lambda w: int(w[4].sum()))
    out["opaque depth-0 shadow"] = shadow
    return out, scene


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", action="store_true",
                    help="then run chip_smoke.py's [tree] and [utils]")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("tree_walk: no CUDA device", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    device = torch.device("cuda", 0)
    cs.phase_device()
    cs.phase_build()
    sweep(device)
    if args.phases:
        torch.cuda.empty_cache()
        cs.phase_tree(device)
        torch.cuda.empty_cache()
        cs.phase_utils(device)
    print(f"[done] {time.perf_counter() - t0:.1f} s")
    return 0


def sweep(device):
    """The walks and the frame at each CHECK_EVERY, and the dense walk."""
    from crt_tpu_torch import RenderSettings, render_image

    waves, scene = shapes(device)
    default = traverse.CHECK_EVERY
    for name, (accel, tri, o, d, act) in waves.items():
        base = traverse.closest_hit_tree(accel, tri, o, d, act)
        times = {k: [] for k in KS}
        stats = {}
        for k in KS + KS[::-1]:
            traverse.CHECK_EVERY = k
            with tracing.recording() as c:
                hit = traverse.closest_hit_tree(accel, tri, o, d, act)
            stats[k] = (c["crt.tree.iterations"],
                        c["crt.host_reads.tree_walk"])
            cs.check(torch.equal(hit.tri, base.tri)
                     and torch.equal(hit.t, base.t),
                     f"{name}: CHECK_EVERY={k} changed a hit")
            times[k].append(wall_ms(
                lambda: traverse.closest_hit_tree(accel, tri, o, d, act)))
        traverse.CHECK_EVERY = default
        dense, dense_its = dense_walk(accel, tri, o, d, act)
        cs.check(torch.equal(dense.tri, base.tri)
                 and torch.equal(dense.t, base.t),
                 f"{name}: the dense walk differs from the shipped one")
        dense_ms = wall_ms(lambda: dense_walk(accel, tri, o, d, act))
        lanes = o[..., 0].numel() if act is None else int(act.sum())
        print(f"[tree-walk] {name} ({lanes} live lanes): "
              + "; ".join(f"CHECK_EVERY={k}: {min(times[k]):.3f}-"
                          f"{max(times[k]):.3f} ms, {stats[k][0]} "
                          f"iterations, {stats[k][1]} host reads"
                          for k in KS)
              + f"; dense walk {dense_ms:.3f} ms, {dense_its} iterations; "
              "hits bit-equal")
    tree = RenderSettings(backend="tree")
    frame = {k: [] for k in KS}
    for k in KS + KS[::-1]:
        traverse.CHECK_EVERY = k
        frame[k].append(wall_ms(lambda: render_image(scene, tree)))
    traverse.CHECK_EVERY = default
    print("[tree-walk] forward tree frame: "
          + "; ".join(f"CHECK_EVERY={k}: {min(v):.3f}-{max(v):.3f} ms"
                      for k, v in frame.items()))
    print(f"[tree-walk] {cs.smi()}")


if __name__ == "__main__":
    sys.exit(main())
