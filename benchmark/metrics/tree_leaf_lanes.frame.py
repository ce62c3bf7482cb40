"""Lanes per frame that the KD walk tests at a hit leaf: the program's
``crt.tree.leaf_lanes`` over the traced frames, each a gather of a leaf
row and a test of its every slot.  A walk that prunes by the hit found so
far reads fewer; ``tree_bound.py`` counts what the answer needs."""

from harness.program_trace import counted
from harness.trace import per_unit


def read(ctx):
    return per_unit(counted("crt.tree.leaf_lanes") or None, ctx.trace)
