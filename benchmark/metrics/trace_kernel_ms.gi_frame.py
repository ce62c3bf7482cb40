"""Device milliseconds per frame of the trace kernels, in the GI cell:
``trace_kernel_ms.frame``'s reader, as the GI cell's, which moves its
own rate ``gi_frame_ms``."""

from harness.registry import metric_reader

read = metric_reader("trace_kernel_ms.frame")
