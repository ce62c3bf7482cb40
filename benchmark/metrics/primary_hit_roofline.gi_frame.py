"""The camera rays' closest hit as a share of its roofline, in the GI
cell: ``primary_hit_roofline``'s reader, as the GI cell's, which moves
its own rate ``gi_frame_ms``."""

from harness.registry import metric_reader

read = metric_reader("primary_hit_roofline")
