from .loss import (  # noqa: F401
    l1_norm,
    log_filter,
    gaussian_kernel,
    hfen,
    temporal_diff,
    sequence_loss,
)
from .schedule import step_lr  # noqa: F401
from .trainer import (TrainState, init_train_state, train_step,  # noqa: F401
                      fit, recalibrate_bn)
from .device_data import fit_device_data, load_device_dataset  # noqa: F401
from .checkpoint import (save_checkpoint, load_checkpoint,  # noqa: F401
                         latest_checkpoint, checkpoint_epoch)
from .logger import MetricsLogger  # noqa: F401
