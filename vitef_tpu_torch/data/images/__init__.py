from .datasets import SyntheticDataset, SyntheticDatasetConfig  # noqa: F401
from .loader import Loader, build_dataset, build_loader  # noqa: F401
from .transforms import IMAGENET_MEAN, IMAGENET_STD, normalize_device, normalize_host  # noqa: F401
