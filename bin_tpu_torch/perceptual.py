"""VGG-16 feature extractor and perceptual loss (``bin_tpu/perceptual.py``).

The layout is ``torchvision.models.vgg16().features``'s: conv indices
0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28, a ReLU after each conv and a
2x2 max-pool at 4, 9, 16, 23, 30, so a torchvision checkpoint loads as it
is (``load_vgg16_params("vgg16-397923af.pth")``; torchvision itself is not
needed).  Without one, ``init_vgg16_params(seed)`` draws the same fixed-seed
He-initialized filters as ``bin_tpu``, bit for bit, from numpy.

``VGG16`` holds the filters as frozen fp32 parameters in channels_last on
the model's device; ``PerceptualLoss`` is the (pred, target) -> scalar
distance of ``make_perceptual_fn``.  Both compute in fp32 whatever the
model's dtype, as ``bin_tpu`` does: the perceptual term is loss-side.  The
convs are cuDNN's (``F.conv2d``): in ``bin_tpu`` they are ``lax.conv``
outside any Pallas kernel.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["VGG16_CHANNELS", "LAYER_TAPS", "init_vgg16_params",
           "torch_state_to_params", "load_vgg16_params", "VGG16",
           "PerceptualLoss", "make_perceptual_fn"]

# conv output channels in torchvision's features order; "M" = 2x2 max-pool
VGG16_CHANNELS = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
                  512, 512, 512, "M", 512, 512, 512, "M")

# tap name -> index into the conv list (the feature after that conv's ReLU)
LAYER_TAPS = {"relu1_2": 1, "relu2_2": 3, "relu3_3": 6, "relu4_3": 9,
              "relu5_3": 12}

_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
_STD = np.array([0.229, 0.224, 0.225], np.float32)


def _conv_channels() -> list[tuple[int, int]]:
    out, cin = [], 3
    for c in VGG16_CHANNELS:
        if c != "M":
            out.append((cin, c))
            cin = c
    return out


def init_vgg16_params(seed: int = 0, num_convs: int | None = None) -> list:
    """The fixed-seed He-initialized conv stack, [(kernel HWIO, bias)] of
    fp32 numpy arrays, ``bin_tpu``'s offline fallback value for value."""
    rng = np.random.default_rng(np.random.SeedSequence(seed))
    params = []
    for cin, cout in _conv_channels()[:num_convs]:
        k = rng.normal(0, np.sqrt(2.0 / (9 * cin)),
                       size=(3, 3, cin, cout)).astype(np.float32)
        params.append((k, np.zeros((cout,), np.float32)))
    return params


def torch_state_to_params(state_dict: dict, num_convs: int | None = None
                          ) -> list:
    """A torchvision VGG ``state_dict`` -> [(kernel HWIO, bias)] in features
    order.  Takes ``features.N.weight`` (the full model) or ``N.weight`` (a
    bare ``nn.Sequential``); a conv weight (cout, cin, kh, kw) becomes (kh,
    kw, cin, cout)."""
    def get(idx, leaf):
        for key in (f"features.{idx}.{leaf}", f"{idx}.{leaf}"):
            if key in state_dict:
                return np.asarray(state_dict[key], dtype=np.float32)
        raise KeyError(f"VGG state_dict missing conv {idx} ({leaf})")

    params = []
    torch_idx = 0
    expected = _conv_channels()[:num_convs]
    for c in VGG16_CHANNELS:
        if c == "M":
            torch_idx += 1  # the MaxPool2d layer
            continue
        if len(params) == len(expected):
            break
        w = get(torch_idx, "weight").transpose(2, 3, 1, 0)
        b = get(torch_idx, "bias")
        cin, cout = expected[len(params)]
        if w.shape != (3, 3, cin, cout):
            raise ValueError(f"conv {torch_idx}: got {w.shape}, "
                             f"expected {(3, 3, cin, cout)}")
        params.append((w, b))
        torch_idx += 2  # Conv2d + ReLU
    return params


def load_vgg16_params(path: str, num_convs: int | None = None) -> list:
    """VGG-16 weights from a torchvision ``.pth`` or an ``.npz`` of the same
    keys."""
    if path.endswith(".npz"):
        with np.load(path) as data:
            state = {k: data[k] for k in data.files}
    else:
        state = torch.load(path, map_location="cpu", weights_only=True)
        state = {k: v.detach().cpu().numpy() for k, v in state.items()}
    return torch_state_to_params(state, num_convs)


class VGG16(nn.Module):
    """The conv stack of ``params`` ([(kernel HWIO, bias)], as far as it
    goes) as frozen fp32 parameters in channels_last on ``device``."""

    def __init__(self, params: list, device: torch.device | str = "cpu"):
        super().__init__()
        self.weights = nn.ParameterList()
        self.biases = nn.ParameterList()
        for k, b in params:
            w = torch.as_tensor(np.asarray(k, np.float32)).permute(3, 2, 0, 1)
            self.weights.append(nn.Parameter(
                w.to(device).contiguous(memory_format=torch.channels_last),
                requires_grad=False))
            self.biases.append(nn.Parameter(
                torch.as_tensor(np.asarray(b, np.float32)).to(device),
                requires_grad=False))
        self.register_buffer("mean", torch.from_numpy(_MEAN).to(device)
                             .view(1, 3, 1, 1), persistent=False)
        self.register_buffer("std", torch.from_numpy(_STD).to(device)
                             .view(1, 3, 1, 1), persistent=False)

    def forward(self, x: torch.Tensor, taps: tuple[int, ...]
                ) -> list[torch.Tensor]:
        """``bin_tpu``'s ``vgg16_features``: x (..., H, W, 3) RGB in [0, 1]
        -> the (..., h, w, C) features after the tapped convs, in fp32.
        The leading dimensions are flattened into the batch; the stack
        stops at the deepest tap."""
        lead = x.shape[:-3]
        x = x.reshape((-1,) + tuple(x.shape[-3:])).float()
        x = x.permute(0, 3, 1, 2)  # NCHW view of channels_last memory
        x = (x - self.mean) / self.std
        feats, conv_i, deepest = [], 0, max(taps)
        for c in VGG16_CHANNELS:
            if c == "M":
                x = F.max_pool2d(x, 2, 2)
                continue
            x = F.relu(F.conv2d(x, self.weights[conv_i], self.biases[conv_i],
                                padding=1))
            if conv_i in taps:
                feats.append(x.permute(0, 2, 3, 1).reshape(
                    lead + (x.shape[2], x.shape[3], x.shape[1])))
                if conv_i == deepest:
                    break
            conv_i += 1
        return feats


class PerceptualLoss(nn.Module):
    """(pred, target) -> the weighted mean-L1 distance of their VGG features
    over ``layers``, divided by the number of taps.  pred and target are
    (..., H, W, 3) RGB in [0, 1], H and W multiples of the pooling that the
    deepest tap reaches."""

    def __init__(self, vgg: VGG16,
                 layers: tuple[str, ...] = ("relu1_2", "relu2_2", "relu3_3"),
                 layer_weights: tuple[float, ...] | None = None):
        super().__init__()
        self.vgg = vgg
        self.taps = tuple(LAYER_TAPS[name] for name in layers)
        self.layer_weights = layer_weights or (1.0,) * len(self.taps)

    def forward(self, pred: torch.Tensor, target: torch.Tensor
                ) -> torch.Tensor:
        fp = self.vgg(pred, self.taps)
        ft = self.vgg(target, self.taps)
        total = torch.zeros((), dtype=torch.float32, device=pred.device)
        for w, a, b in zip(self.layer_weights, fp, ft):
            total = total + w * (a - b).abs().mean()
        return total / len(self.taps)


def make_perceptual_fn(params: list,
                       layers: tuple[str, ...] = ("relu1_2", "relu2_2",
                                                  "relu3_3"),
                       layer_weights: tuple[float, ...] | None = None,
                       device: torch.device | str = "cpu") -> PerceptualLoss:
    """``bin_tpu``'s ``make_perceptual_fn``: the loss over ``params`` put on
    ``device``."""
    return PerceptualLoss(VGG16(params, device), layers, layer_weights)
