"""Device-to-host reads per frame, in the GI cell:
``host_reads.frame``'s reader, as the GI cell's, which moves its own
rate ``gi_frame_ms``."""

from harness.registry import metric_reader

read = metric_reader("host_reads.frame")
