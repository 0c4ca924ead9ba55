"""The serving daemon of the port and its client."""

__all__ = ["StreamClient", "FrameServer", "serve_main"]


def __getattr__(name: str):
    # imported on first use, so that ``python -m
    # bin_tpu_torch.serving.server`` does not find the module loaded by its
    # own package
    if name == "StreamClient":
        from bin_tpu_torch.serving.client import StreamClient
        return StreamClient
    if name in __all__:
        from bin_tpu_torch.serving import server
        return getattr(server, name)
    raise AttributeError(name)
