from qaray_tpu_torch.parallel.mesh import (  # noqa: F401
    make_render_mesh,
    shard_render_batch,
)
