"""Tensor ops of the port; ``lstm_gates`` and ``pixel_shuffle`` hold the
CUDA kernels K1 and K2 (sources in ``bin_tpu_torch/csrc``)."""
