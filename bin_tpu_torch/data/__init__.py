"""Data of the port: the synthetic clips and training batches of
``bin_tpu.data``, copied."""

from bin_tpu_torch.data.pipeline import (SyntheticSource, eval_clips,
                                         train_iterator)

__all__ = ["SyntheticSource", "eval_clips", "train_iterator"]
