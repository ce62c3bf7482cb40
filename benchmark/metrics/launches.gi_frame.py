"""Kernel launches per frame, in the GI cell: ``launches.frame``'s
reader, as the GI cell's, which moves its own rate ``gi_frame_ms``."""

from harness.registry import metric_reader

read = metric_reader("launches.frame")
