"""Milliseconds per frame, in the GI cell: ``frame_ms``'s reader, as the
GI cell's own rate, apart from the other frame cells' ``frame_ms``, so
that each is held to a bound of its own."""

from harness.registry import metric_reader

read = metric_reader("frame_ms")
