from .autoencoder import (apply_frame, apply_sequence,  # noqa: F401
                          init_autoencoder, init_hidden, param_count)
from .export import (load_model, model_options_from_meta,  # noqa: F401
                     model_options_from_params, params_from_numpy, save_model,
                     train_state_from_numpy, train_state_to_numpy)
from .inference import (  # noqa: F401
    apply_frame_fast,
    apply_frame_fast_padded,
    apply_sequence_fast,
    fold_batchnorm,
    padded_resolution,
    prepare_inference,
)
