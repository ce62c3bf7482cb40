"""The intersection backend as shading sees it.

Every backend (``ops/cluster_trace.py``, ``ops/stream_trace.py``,
``ops/traverse.py``, the all-pairs and empty ones in ``renderer.py``, the
partitioned ones in ``parallel/scene_sharded.py``) is a ``Tracer``.  The
class states the whole interface that ``ops/shade.py`` and
``ops/shade_iter.py`` use, and its defaults are the reference behaviour:
a shadow pass is a closest hit with a ``t^2 <= r^2`` compare, and no lane
of a transmissive shadow pass skips the march.  A backend overrides
``shadow`` and ``shadow_glass`` only where it has a kernel for them.

Shading reads only plain attributes and calls methods, never
``isinstance``: wrappers that forward attributes (the benchmark's spans,
the tests' counters) stand in for a tracer.
"""

from __future__ import annotations

from crt_tpu_torch.ops.intersect import Hit


class Tracer:
    """An intersection backend.

    ``emits_rows``: ``with_rows`` gives the kernel's packed rows.
    ``rank``: the [T] triangle id -> rank map that keeps the segment sum's
    id bands narrow, or None.  ``read_rows``: None, or ``tri [N] -> [K, N]``
    that replaces every read of the packed shading table (a partitioned
    scene, whose rows come back through an exchange).
    """

    emits_rows = False
    rank = None
    read_rows = None

    def __call__(self, origins, dirs, active=None) -> Hit:
        """The closest hit of rays of any batch shape; ``active=False``
        lanes may be skipped."""
        raise NotImplementedError

    def with_rows(self, origins, dirs, active=None):
        """(Hit, rows [K+1, R]): the closest hit and the packed rows the
        kernel emitted, the slot rank last.  Only where ``emits_rows``."""
        raise NotImplementedError

    def shadow(self, point, shadow_o, light_positions, light_dirs, r2,
               active, origin_slack):
        """Opaque occlusion masks of a point-light shadow wavefront ->
        occluded [Ll, *R] bool.

        ``point`` [*R, 3] the hit points, ``shadow_o`` [*R, 3] the biased
        origins shared by the lights, ``light_positions`` [Ll, 3],
        ``light_dirs`` [Ll, *R, 3], ``r2`` and ``active`` [Ll, *R],
        ``origin_slack`` the origins' distance from the points.  Here: the
        closest hit of the stacked [Ll * R] wavefront, blocked where
        t^2 <= r^2."""
        del point, light_positions, origin_slack
        sh = self(shadow_o.detach().expand(light_dirs.shape).reshape(-1, 3),
                  light_dirs.detach().reshape(-1, 3), active.reshape(-1))
        return (sh.valid & (sh.t * sh.t <= r2.detach().reshape(-1))
                ).reshape(r2.shape)

    def shadow_glass(self, point, shadow_o, light_positions, active,
                     origin_slack):
        """The march router of a transmissive shadow pass ->
        (occluded [Ll, R], glass [Ll, R]), "glass": some refractive
        member lies anywhere on the unbounded shadow ray; None where the
        backend has no router, and then every shadow lane marches."""
        del point, shadow_o, light_positions, active, origin_slack
        return None
