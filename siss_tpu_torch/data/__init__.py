from siss_tpu_torch.data.datasets import (
    ArrayDataset,
    LabeledImageDataset,
    normalize_to_unit_range,
)
from siss_tpu_torch.data.loader import BatchLoader, dual_stream
from siss_tpu_torch.data.samplers import InfiniteSampler
from siss_tpu_torch.data.synthetic import make_synthetic_mnist_tshirt

__all__ = ["ArrayDataset", "LabeledImageDataset", "normalize_to_unit_range", "BatchLoader",
           "dual_stream", "InfiniteSampler", "make_synthetic_mnist_tshirt"]
