"""Signal processing: the convolutions of ``conv``."""

from pytensor_tpu_torch.tensor.signal.conv import convolve1d, convolve2d
