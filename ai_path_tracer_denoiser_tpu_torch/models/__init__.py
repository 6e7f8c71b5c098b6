from .autoencoder import init_autoencoder, init_hidden  # noqa: F401
from .export import (load_model, model_options_from_meta,  # noqa: F401
                     params_from_numpy)
from .inference import (  # noqa: F401
    apply_frame_fast,
    apply_frame_fast_padded,
    fold_batchnorm,
    padded_resolution,
    prepare_inference,
)
