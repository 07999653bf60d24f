from siss_tpu_torch.data.datasets import (
    ArrayDataset,
    ImageFolderDataset,
    LabeledImageDataset,
    SDData,
    normalize_to_unit_range,
    read_image,
)
from siss_tpu_torch.data.loader import BatchLoader, dual_stream
from siss_tpu_torch.data.samplers import InfiniteSampler, RepeatedSampler
from siss_tpu_torch.data.synthetic import make_synthetic_mnist_tshirt

__all__ = ["ArrayDataset", "ImageFolderDataset", "LabeledImageDataset", "SDData",
           "normalize_to_unit_range",
           "read_image", "BatchLoader", "dual_stream", "InfiniteSampler", "RepeatedSampler",
           "make_synthetic_mnist_tshirt"]
