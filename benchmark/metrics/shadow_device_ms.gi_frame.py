"""Device milliseconds per frame of the opaque shadow pass, in a cell that
reports ``gi_frame_ms``: ``shadow_device_ms.frame``'s reader, which moves
that cell's own rate."""

from harness.registry import metric_reader

read = metric_reader("shadow_device_ms.frame")
