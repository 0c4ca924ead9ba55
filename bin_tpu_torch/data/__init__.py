"""Eval data of the port: the synthetic clips of ``bin_tpu.data``, copied."""

from bin_tpu_torch.data.pipeline import SyntheticSource, eval_clips

__all__ = ["SyntheticSource", "eval_clips"]
