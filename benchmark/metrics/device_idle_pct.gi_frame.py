"""Share of the traced window in which no device operation ran, in the
GI cell: ``device_idle_pct.frame``'s reader, as the GI cell's, which
moves its own rate ``gi_frame_ms``."""

from harness.registry import metric_reader

read = metric_reader("device_idle_pct.frame")
