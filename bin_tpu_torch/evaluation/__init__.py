"""Evaluation (clip inference + PSNR/SSIM tables) and streaming sessions."""

__all__ = ["evaluate", "evaluate_cli"]


def __getattr__(name: str):
    # imported on first use, so that ``python -m
    # bin_tpu_torch.evaluation.evaluator`` does not find the module loaded
    # by its own package
    if name in __all__:
        from bin_tpu_torch.evaluation import evaluator
        return getattr(evaluator, name)
    raise AttributeError(name)
