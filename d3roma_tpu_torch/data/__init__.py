"""The datasets (active stereo, passive stereo with its augmentation), their
loader, the prefetch to the device and the on-device preprocessing."""

from d3roma_tpu_torch.data.loader import (  # noqa: F401
    MONO_DATASETS,
    STEREO_DATASETS,
    DataLoader,
    collate,
    create_dataset,
    fetch_dataloader,
    val_loaders,
)
from d3roma_tpu_torch.data.preprocess import device_preprocess, preprocess_eval  # noqa: F401
