"""Device milliseconds per frame of the shading entry, in the GI cell:
``shade_device_ms.frame``'s reader, as the GI cell's, which moves its
own rate ``gi_frame_ms``."""

from harness.registry import metric_reader

read = metric_reader("shade_device_ms.frame")
