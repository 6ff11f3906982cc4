from .datasets import SyntheticDataset, SyntheticDatasetConfig  # noqa: F401
from .loader import (  # noqa: F401
    Loader,
    build_dataset,
    build_loader,
    build_train_val_loader,
    make_iterable,
)
from .transforms import (  # noqa: F401
    IMAGENET_MEAN,
    IMAGENET_STD,
    augment_train_device,
    augment_train_reference,
    normalize_device,
    normalize_host,
    sample_crop_batch,
    sample_resized_crop_params,
)
