from .dataset import SequenceDataset, find_max, sequence_batches  # noqa: F401
from .datagen import generate_training_data  # noqa: F401
from .preprocess import preprocess_png_dirs  # noqa: F401
