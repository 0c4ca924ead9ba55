"""Space-to-depth / depth-to-space in ``bin_tpu``'s channel order.

Output channel (dy*f + dx)*C + c, pixel-major (``bin_tpu/ops/pixel_shuffle.py``).
This is not ``F.pixel_unshuffle``'s order, which is (c, dy, dx).
``space_to_depth`` of a CUDA tensor runs the kernel K2
(``bin_tpu_torch/csrc/s2d_pack.cu``); ``space_to_depth_ref`` is its plain
version.  ``depth_to_space`` is plain PyTorch, as the pack's gradient is
plain ``jnp`` in ``bin_tpu``; it is ``space_to_depth``'s backward
(``bin_tpu/ops/pallas/s2d_pack.py`` ``_bwd``), so a packed CUDA tensor
keeps its gradient.
"""

from __future__ import annotations

import math

import torch

from bin_tpu_torch.ops import native

__all__ = ["space_to_depth", "space_to_depth_ref", "depth_to_space",
           "pack_plan", "launches"]

launches = 0  # kernel launches by space_to_depth

_ELEM_SIZE = {torch.uint8: 1, torch.bfloat16: 2, torch.float32: 4}


def _check_divisible(shape, factor: int) -> None:
    h, w = shape[-3], shape[-2]
    if h % factor or w % factor:
        raise ValueError(f"spatial dims {(h, w)} not divisible by {factor}")


def space_to_depth_ref(x: torch.Tensor, factor: int) -> torch.Tensor:
    """(..., H, W, C) -> (..., H/f, W/f, f*f*C), plain PyTorch."""
    if factor == 1:
        return x
    _check_divisible(x.shape, factor)
    *lead, h, w, c = x.shape
    x = x.reshape(*lead, h // factor, factor, w // factor, factor, c)
    x = x.movedim(-4, -3)  # (..., H/f, W/f, fy, fx, C)
    return x.reshape(*lead, h // factor, w // factor, factor * factor * c)


STAGE_BYTES = 16384  # input bytes of one K2 tile; the kernel rings 3 stages


def pack_plan(row_bytes: int, run_bytes: int, factor: int, *addresses: int,
              stage_bytes: int = STAGE_BYTES) -> tuple[int, int, int]:
    """K2's plan for input rows of ``row_bytes`` and runs (f*C values) of
    ``run_bytes``: ``(word, cells, slice)``.

    ``word`` is the widest global access (16, 8, 4, 2 or 1 bytes) that
    divides the row and every address.  A tile stages ``cells`` output cells
    of one band, ``slice`` bytes of each run (all of it, unless one run
    per dy overflows a stage), at most ``stage_bytes`` of input, with
    ``cells * slice`` a whole number of words."""
    word = next(wd for wd in (16, 8, 4, 2, 1) if row_bytes % wd == 0
                and all(a % wd == 0 for a in addresses))
    step = word // math.gcd(run_bytes, word)  # cells that fill whole words
    if factor * step * run_bytes <= stage_bytes:
        fit = stage_bytes // (factor * run_bytes) // step * step
        return word, min(row_bytes // run_bytes, fit), run_bytes
    word = math.gcd(word, run_bytes)
    fit = stage_bytes // factor // word * word
    return word, 1, min(run_bytes, max(word, fit))


class _SpaceToDepth(torch.autograd.Function):
    """The pack, whose gradient is the inverse permutation."""

    @staticmethod
    def forward(ctx, x, factor: int):
        ctx.factor = factor
        if x.device.type == "cpu":
            return space_to_depth_ref(x, factor)
        return _k2(x, factor)

    @staticmethod
    def backward(ctx, grad):
        return depth_to_space(grad, ctx.factor), None


def space_to_depth(x: torch.Tensor, factor: int) -> torch.Tensor:
    """``space_to_depth_ref`` as one pass: the plain version for a CPU
    tensor, the CUDA kernel for a CUDA tensor (uint8, bfloat16 or float32,
    contiguous), or an error.  f=1 returns ``x`` itself.  Differentiable:
    the gradient is ``depth_to_space``."""
    if factor == 1:
        return x
    _check_divisible(x.shape, factor)
    if x.device.type != "cpu":
        _check_k2(x)
    return _SpaceToDepth.apply(x, factor)


def _check_k2(x: torch.Tensor) -> None:
    """Raise unless ``x`` is what the kernel takes."""
    if not x.is_cuda:
        raise ValueError(f"space_to_depth: tensor on {x.device}; the kernel "
                         "takes CUDA tensors")
    if x.dtype not in _ELEM_SIZE:
        raise ValueError(f"space_to_depth: dtype {x.dtype}; the kernel takes "
                         "uint8, bfloat16 or float32")
    if x.dim() < 3 or not x.is_contiguous():
        raise ValueError("space_to_depth: the kernel takes a contiguous "
                         "(..., H, W, C) tensor")


def _k2(x: torch.Tensor, factor: int) -> torch.Tensor:
    """Launch K2 on a checked CUDA tensor."""
    *lead, h, w, c = x.shape
    out = torch.empty((*lead, h // factor, w // factor, factor * factor * c),
                      dtype=x.dtype, device=x.device)
    if x.numel() == 0:
        return out
    lib = native.library()
    row_bytes = w * c * x.element_size()
    run_bytes = factor * c * x.element_size()
    word, cells, slice_ = pack_plan(row_bytes, run_bytes, factor,
                                    x.data_ptr(), out.data_ptr())
    with torch.cuda.device(x.device):
        err = lib.btt_s2d_pack(
            x.data_ptr(), out.data_ptr(), x.numel() // (w * c * factor),
            factor, row_bytes, run_bytes, word, cells, slice_,
            native.stream(x.device))
    native.check(err, "btt_s2d_pack")
    global launches
    launches += 1
    return out


def depth_to_space(x: torch.Tensor, factor: int) -> torch.Tensor:
    """(..., H, W, f*f*C) -> (..., H*f, W*f, C), inverse of space_to_depth."""
    if factor == 1:
        return x
    *lead, h, w, cff = x.shape
    c = cff // (factor * factor)
    x = x.reshape(*lead, h, w, factor, factor, c)
    x = x.movedim(-3, -4)  # (..., H, fy, W, fx, C)
    return x.reshape(*lead, h * factor, w * factor, c)
