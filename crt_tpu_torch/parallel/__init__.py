from crt_tpu_torch.parallel.sharded import (
    inverse_render_step,
    make_mesh,
    render_image_sharded,
)

__all__ = ["make_mesh", "render_image_sharded", "inverse_render_step"]
