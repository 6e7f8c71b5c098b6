from .mesh import make_mesh, data_spec, replicated  # noqa: F401
from .dp import make_dp_train_step, shard_batch  # noqa: F401
from .render_shard import render_sharded  # noqa: F401
from .spatial import denoise_frame_spatial, denoise_sequence_spatial  # noqa: F401
