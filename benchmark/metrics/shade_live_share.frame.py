"""Share of the lanes the iterative wavefront shades that are live, in a
frame cell: ``pool_live_share.gi_frame``'s reader, as a cell's that
moves ``frame_ms`` (how empty the scan pool's bounces are)."""

from harness.registry import metric_reader

read = metric_reader("pool_live_share.gi_frame")
