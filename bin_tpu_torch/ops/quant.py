"""Post-training int8 conv of the serving mode: the CUDA kernels K3q
(activation quantize) and K3 (int8 implicit-GEMM 3x3 conv), with their
plain PyTorch versions, after ``bin_tpu/ops/quant.py``.  K3's epilogue
also takes the pass that follows the conv in the backbone (a LeakyReLU, a
residual add), in the order the eager model runs it.

Scheme, as ``bin_tpu``'s ``int8_conv``: weights symmetric int8 per output
channel (abs-max / 127, the amax floored at 1e-8), activations on one
per-tensor scale (a static calibrated one from the scales sidecar, or the
dynamic abs-max), ``round(x / s)`` half to even and clipped to +-127,
int32 sums, then ``fp32(acc) * (ascale * kscale) (+ bias)`` in fp32 with no
fused multiply-add, then the output dtype.  Every step is an exact or
correctly rounded IEEE operation, so the kernels and their plain versions
agree bit for bit, and with ``bin_tpu`` wherever their inputs agree.

The kernels are ``bin_tpu_torch/csrc/int8_conv.cu``; they have no Pallas
counterpart (``bin_tpu`` runs the conv as one XLA conv with int8 operands).
The wrappers take the plain versions for CPU tensors only; for a CUDA
tensor they launch the kernel or raise.

Quantization-aware training (``ModelConfig.conv_int8_qat``) trains through
``fake_quant`` and ``fake_quant_conv``, plain PyTorch on both devices, as
they are XLA ops in ``bin_tpu``: the same quantizer, with a
straight-through gradient.
"""

from __future__ import annotations

import functools
import os

import numpy as np
import torch
import torch.nn.functional as F

from bin_tpu_torch.ops import native

__all__ = ["lookup_act_scale", "load_act_scales", "scales_calibrated_for",
           "quantize_symmetric", "fake_quant", "fake_quant_conv",
           "quantize_weight", "quantize_act",
           "quantize_act_ref", "int8_conv3x3", "int8_conv3x3_ref",
           "int8_conv_ref", "dequantize_ref", "epilogue_ref", "int8_conv",
           "activation_scale", "quantize_launches", "conv_launches"]

quantize_launches = 0  # K3q launches by quantize_act
conv_launches = 0      # K3 launches by int8_conv3x3

# what the kernel takes (csrc/int8_conv.cu): K chunks of 32, 64 or 128
# input channels, each inside one tap, and output columns written in pairs
CIN_MULTIPLE = 32
COUT_MULTIPLE = 8


def lookup_act_scale(scales: dict, key: str) -> float:
    """Strict calibrated-scale lookup with remediation context.

    A missing key means the sidecar was calibrated against a different
    architecture or scope than the one being built (e.g. a deeper variant,
    or conv_int8_lstm enabled after calibration); a silent dynamic-scale
    fallback would un-gate the measurement the static scales were
    promoted on."""
    if key not in scales:
        raise KeyError(
            f"no calibrated activation scale for conv {key!r} "
            f"(have {sorted(scales)[:8]}...); re-run "
            "tools/calibrate_int8.py against this architecture/scope")
    return scales[key]


@functools.lru_cache(maxsize=8)
def load_act_scales(path: str) -> dict:
    """Calibrated static activation scales (.npz written by
    tools/calibrate_int8.py): {conv path key -> fp32 scale}, cached per
    path.  A relative path that does not resolve against the working
    directory is retried against the repo root.  Dunder keys
    (``__calibrated_for__``, ...) are sidecar metadata, not conv scales,
    and are skipped (``scales_calibrated_for`` reads them)."""
    with np.load(_resolve_repo_relative(path)) as data:
        return {k: float(data[k]) for k in data.files
                if not k.startswith("__")}


def _resolve_repo_relative(path: str) -> str:
    if not os.path.isabs(path) and not os.path.exists(path):
        root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        candidate = os.path.join(root, path)
        if os.path.exists(candidate):
            return candidate
    return path


def scales_calibrated_for(path: str) -> str | None:
    """The weights basename a scales sidecar was calibrated against
    (``__calibrated_for__``), or None for a sidecar without provenance or
    a file that cannot be read."""
    try:
        with np.load(_resolve_repo_relative(path)) as data:
            if "__calibrated_for__" in data.files:
                return str(data["__calibrated_for__"])
    except (OSError, ValueError):
        pass
    return None


def quantize_symmetric(x: torch.Tensor, dim=None, mse_clip: bool = False):
    """Symmetric int8 quantization: (q, scale) with x ~ q * scale.
    ``dim``: the dimensions reduced per kept channel (None = per tensor;
    the scale then keeps them as size 1).

    ``mse_clip=True`` replaces the abs-max scale by the clipped one of
    least squared error: per kept channel, of the scales c * amax / 127 for
    21 values of c from 0.5 to 1.0, the one whose quantize-dequantize
    round trip is nearest ``x`` (the first of equals).  Abs-max lets one
    outlier stretch a whole channel's grid; clipping trades its error for
    a finer grid elsewhere.  For weights; no config reaches it."""
    xf = x.float()
    keep = dim is not None

    def amax_of(v):
        return v.amax(dim=dim, keepdim=True) if keep else v.amax()

    amax = amax_of(xf.abs())
    scale = amax.clamp_min(1e-8) / 127.0
    if mse_clip:
        best_err = None
        for c in _MSE_CLIP_CANDIDATES:
            s = (amax * c).clamp_min(1e-8) / 127.0
            dq = torch.clamp(torch.round(xf / s), -127, 127) * s
            sq = (xf - dq).square()
            err = sq.sum(dim=dim, keepdim=True) if keep else sq.sum()
            if best_err is None:
                best_err, scale = err, s
            else:
                take = err < best_err
                best_err = torch.where(take, err, best_err)
                scale = torch.where(take, s, scale)
    q = torch.clamp(torch.round(xf / scale), -127, 127)
    return q.to(torch.int8), scale


# the fp32 values of bin_tpu's jnp.linspace(0.5, 1.0, 21), two of which
# (0.70000005, 0.72499996) are one ulp off numpy's
_MSE_CLIP_CANDIDATES = tuple(float(np.float32(v)) for v in (
    "0.5", "0.525", "0.55", "0.575", "0.6", "0.625", "0.65", "0.675",
    "0.70000005", "0.72499996", "0.75", "0.775", "0.8", "0.825", "0.85",
    "0.875", "0.9", "0.925", "0.95", "0.975", "1.0"))


def fake_quant(x: torch.Tensor, dim=None) -> torch.Tensor:
    """Quantize-dequantize with a straight-through gradient (QAT),
    ``bin_tpu/ops/quant.py`` ``fake_quant``: the quantizer of
    ``quantize_symmetric`` (abs-max scale, detached; round half to even,
    clip to +-127), returned as ``x + (qdq - x).detach()`` in ``x``'s
    dtype, so the gradient passes the round and the clip unchanged."""
    xf = x.float()
    q, scale = quantize_symmetric(xf.detach(), dim)
    return (xf + (q.float() * scale - xf).detach()).to(x.dtype)


def _pad_nchw(x: torch.Tensor, stride: int, pad: tuple[int, int]):
    """An NHWC tensor as the padded NCHW view a VALID 3x3 conv of ``stride``
    takes for the SAME output size, top/left padding ``pad``."""
    _, h, w, _ = x.shape
    pt, pl = pad
    pb = (out_size(h, stride) - 1) * stride + 3 - h - pt
    pr = (out_size(w, stride) - 1) * stride + 3 - w - pl
    return F.pad(x.permute(0, 3, 1, 2), (pl, pr, pt, pb))


class _FakeQuantConv(torch.autograd.Function):
    """conv(fake_quant(x), fake_quant(weight, per output channel)), no
    bias, NHWC fp32 in and out.

    Forward as the int8 conv: the integer operands q (|q| <= 127) as fp32
    values, convolved, then times ``sx * sk``.  Each q is exact in bf16
    and in TF32, each product in fp32, and the sums while they stay below
    2^24, so the result is the int8 path's whatever cuDNN's TF32 setting:
    a conv of the dequantized values under TF32 would round each q * s to
    10 mantissa bits, the noise ``bin_tpu``'s fp32 conv keeps out.
    Backward: the straight-through gradient, the conv's VJP at the
    dequantized operands (``q * s``), in fp32 under the caller's settings.
    Saves the int8 operands and their scales, not fp32 copies."""

    @staticmethod
    def forward(ctx, x, weight, stride: int, pad: tuple[int, int]):
        qx, sx = quantize_symmetric(x)
        qk, sk = quantize_symmetric(weight, dim=(1, 2, 3))
        xp = _pad_nchw(qx.float(), stride, pad)
        acc = F.conv2d(xp, qk.float(), None, stride)
        ctx.save_for_backward(qx, sx, qk, sk)
        ctx.stride, ctx.pad = stride, pad
        return acc.permute(0, 2, 3, 1) * (sx * sk.reshape(-1))

    @staticmethod
    def backward(ctx, dy):
        qx, sx, qk, sk = ctx.saved_tensors
        stride, (pt, pl) = ctx.stride, ctx.pad
        xp = _pad_nchw(qx.float() * sx, stride, (pt, pl))
        need_x, need_w = ctx.needs_input_grad[:2]
        dxp, dw, _ = torch.ops.aten.convolution_backward(
            dy.permute(0, 3, 1, 2), xp, qk.float() * sk, None,
            (stride, stride), (0, 0), (1, 1), False, (0, 0), 1,
            (need_x, need_w, False))
        dx = None
        if need_x:
            h, w = qx.shape[1:3]
            dx = dxp[:, :, pt:pt + h, pl:pl + w].permute(0, 2, 3, 1)
        return dx, dw, None, None


def fake_quant_conv(x: torch.Tensor, weight: torch.Tensor,
                    bias: torch.Tensor | None, stride: int = 1,
                    pad: tuple[int, int] = (1, 1)) -> torch.Tensor:
    """QAT twin of ``int8_conv``, ``bin_tpu/ops/quant.py``
    ``fake_quant_conv``: the 3x3 conv (SAME output size, top/left padding
    ``pad``) of ``fake_quant(x)`` (per tensor) and ``fake_quant(weight)``
    (per output channel), then the fp32 bias.  NHWC ``x`` of any float
    dtype, taken to fp32; ``weight`` (O, I, 3, 3).  Returns fp32; the
    caller casts.  Equals the int8 path with the dynamic scale (K3q + K3)
    wherever its integer sums stay below 2^24 (``_FakeQuantConv``), and
    ``bin_tpu``'s fp32 conv of the dequantized values within fp32
    rounding; differentiable in ``x``, ``weight`` and ``bias``."""
    out = _FakeQuantConv.apply(x.float(), weight.float(), stride, pad)
    if bias is not None:
        out = out + bias.float()
    return out


def quantize_weight(weight: torch.Tensor):
    """A conv weight (O, I, kh, kw), fp32 -> (q, kscale): q packed for K3
    as (O, kh, kw, I) int8, contiguous; kscale (O,) fp32."""
    if weight.dtype != torch.float32:
        raise ValueError(f"quantize the fp32 weights, got {weight.dtype}: a "
                         "cast first would move the scales")
    q, scale = quantize_symmetric(weight, dim=(1, 2, 3))
    return q.permute(0, 2, 3, 1).contiguous(), scale.reshape(-1)


def _cpu_or_cuda(name: str, *tensors) -> bool:
    """True for CPU tensors (take the plain version), False for tensors on
    one CUDA device (launch the kernel); raise for anything else."""
    devices = {t.device for t in tensors if t is not None}
    if all(d.type == "cpu" for d in devices):
        return True
    if len(devices) == 1 and all(t.is_cuda for t in tensors if t is not None):
        return False
    raise ValueError(f"{name}: tensors on {sorted(map(str, devices))}; all "
                     "must be on one CUDA device or all on the CPU")


def _refuse_grad(name: str, *tensors) -> None:
    """Raise where autograd would want a gradient: the int8 ops have no
    backward (PTQ is inference only, as in ``bin_tpu``; training takes
    ``fake_quant_conv``), and a kernel's output would carry none."""
    if torch.is_grad_enabled() and any(
            torch.is_tensor(t) and t.requires_grad for t in tensors):
        raise RuntimeError(f"{name}: an input requires grad, but the int8 "
                           "ops have no backward (PTQ is inference only; "
                           "train with model.conv_int8_qat)")


def quantize_act_ref(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """clamp(round(x / scale), -127, 127) as int8, in fp32: a division,
    not a multiply by 1/scale, as ``bin_tpu``."""
    return torch.clamp(torch.round(x.float() / scale), -127, 127).to(
        torch.int8)


def quantize_act(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``quantize_act_ref`` as the kernel K3q for CUDA tensors.

    On CUDA: ``x`` bf16 or fp32, contiguous, 16-byte aligned; ``scale`` a
    one-element fp32 tensor on the same device (read by the kernel, so no
    host sync).  Raises where grad mode is on and an input requires grad."""
    _refuse_grad("quantize_act", x, scale)
    if _cpu_or_cuda("quantize_act", x, scale):
        return quantize_act_ref(x, scale)
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"quantize_act: x dtype {x.dtype}; the kernel takes "
                         "bfloat16 or float32")
    if scale.dtype != torch.float32 or scale.numel() != 1:
        raise ValueError("quantize_act: scale must be one float32 value")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("quantize_act: x must be contiguous and 16-byte "
                         "aligned")
    q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    if x.numel() == 0:
        return q
    lib = native.library()
    with torch.cuda.device(x.device):
        err = lib.btt_quantize_act(
            x.data_ptr(), int(x.dtype == torch.bfloat16), scale.data_ptr(),
            q.data_ptr(), x.numel(), native.stream(x.device))
    native.check(err, "btt_quantize_act")
    global quantize_launches
    quantize_launches += 1
    return q


def out_size(size: int, stride: int) -> int:
    """Output size of a SAME conv."""
    return -(-size // stride)


def int8_conv_ref(xq: torch.Tensor, qweight: torch.Tensor, stride: int,
                  pad: tuple[int, int],
                  out_rows: int | None = None) -> torch.Tensor:
    """The int32 sums of a 3x3 conv, SAME output size, top/left padding
    ``pad`` (the rest of the border reads zero): im2col by padding and nine
    strided slices, concatenated in (kh, kw, cin) order, then
    ``torch._int_mm``.  ``out_rows``: the output height Ho where it is not
    SAME's (a band with its halo rows, top padding 0: the band's rows).

    xq (N, H, W, Cin) int8; qweight (Cout, 3, 3, Cin) int8.  Returns (N,
    Ho, Wo, Cout) int32."""
    n, h, w, cin = xq.shape
    cout = qweight.shape[0]
    ho = out_size(h, stride) if out_rows is None else out_rows
    wo = out_size(w, stride)
    pt, pl = pad
    pb = (ho - 1) * stride + 3 - h - pt
    pr = (wo - 1) * stride + 3 - w - pl
    xp = F.pad(xq, (0, 0, pl, pr, pt, pb))
    taps = [xp[:, kh:kh + (ho - 1) * stride + 1:stride,
               kw:kw + (wo - 1) * stride + 1:stride]
            for kh in range(3) for kw in range(3)]
    patches = torch.cat(taps, dim=-1).reshape(n * ho * wo, 9 * cin)
    acc = torch._int_mm(patches, qweight.reshape(cout, 9 * cin).t())
    return acc.reshape(n, ho, wo, cout)


def dequantize_ref(acc: torch.Tensor, ascale: torch.Tensor,
                   kscale: torch.Tensor, bias: torch.Tensor | None,
                   out_dtype: torch.dtype,
                   addend: torch.Tensor | None = None) -> torch.Tensor:
    """K3's epilogue: fp32(acc) * (ascale * kscale), + bias, addend + that,
    each rounded on its own, then the cast."""
    v = acc.float() * (ascale * kscale)
    if bias is not None:
        v = v + bias
    if addend is not None:
        v = addend + v
    return v.to(out_dtype)


def epilogue_ref(v: torch.Tensor, slope: float | None = None,
                 residual: torch.Tensor | None = None) -> torch.Tensor:
    """The pass after a conv in the backbone, as the eager model runs it:
    ``F.leaky_relu`` in ``v``'s dtype, then ``residual + v``.  ``v`` is the
    conv's fresh output: the sum goes into it in place (the same IEEE sum),
    so that no tensor is allocated while the caller still holds the conv's
    input."""
    if slope is not None:
        v = F.leaky_relu(v, slope)
    if residual is not None:
        v = v.add_(residual)
    return v


def int8_conv3x3_ref(xq, qweight, kscale, ascale, bias, stride, pad,
                     out_dtype, addend=None, slope=None, residual=None,
                     out_rows=None):
    """The plain version of K3: ``int8_conv_ref``, ``dequantize_ref``, then
    ``epilogue_ref``."""
    return epilogue_ref(
        dequantize_ref(int8_conv_ref(xq, qweight, stride, pad, out_rows),
                       ascale, kscale, bias, out_dtype, addend), slope,
        residual)


def int8_conv3x3(xq: torch.Tensor, qweight: torch.Tensor,
                 kscale: torch.Tensor, ascale: torch.Tensor,
                 bias: torch.Tensor | None, stride: int,
                 pad: tuple[int, int], out_dtype: torch.dtype,
                 addend: torch.Tensor | None = None,
                 slope: float | None = None,
                 residual: torch.Tensor | None = None,
                 out_rows: int | None = None) -> torch.Tensor:
    """``int8_conv3x3_ref`` as the kernel K3 for CUDA tensors.

    On CUDA: xq (N, H, W, Cin) int8 contiguous with Cin a multiple of 32,
    fewer than 2^31 outputs;
    qweight (Cout, 3, 3, Cin) int8 contiguous with Cout a multiple of 8;
    kscale (Cout,), bias (Cout,) or None, ascale one value, all fp32;
    addend None or (N, Ho, Wo, Cout) fp32 contiguous; residual None or
    (N, Ho, Wo, Cout) in ``out_dtype``, contiguous; kscale, bias, addend
    and residual 16-byte aligned;
    out_dtype bf16 or fp32; stride 1 or 2; 0 <= pad < 3; ``out_rows``
    (Ho; SAME's where None) from 1 to SAME's.  Anything else raises."""
    if _cpu_or_cuda("int8_conv3x3", xq, qweight, kscale, ascale, bias,
                    addend, residual):
        return int8_conv3x3_ref(xq, qweight, kscale, ascale, bias, stride,
                                pad, out_dtype, addend, slope, residual,
                                out_rows)
    n, h, w, cin = xq.shape
    cout = qweight.shape[0]
    ho, wo = out_size(h, stride), out_size(w, stride)
    if out_rows is not None:
        if not 1 <= out_rows <= ho:
            raise ValueError(f"int8_conv3x3: out_rows {out_rows}; the "
                             f"kernel takes 1 to {ho} for H {h}")
        ho = out_rows
    if xq.dtype != torch.int8 or qweight.dtype != torch.int8:
        raise ValueError("int8_conv3x3: xq and qweight must be int8")
    if tuple(qweight.shape) != (cout, 3, 3, cin):
        raise ValueError(f"int8_conv3x3: qweight {tuple(qweight.shape)} is "
                         f"not (Cout, 3, 3, {cin})")
    if cin % CIN_MULTIPLE or cout % COUT_MULTIPLE:
        raise ValueError(f"int8_conv3x3: Cin {cin}, Cout {cout}; the kernel "
                         f"takes Cin a multiple of {CIN_MULTIPLE} and Cout "
                         f"a multiple of {COUT_MULTIPLE}")
    if stride not in (1, 2) or not all(0 <= p < 3 for p in pad):
        raise ValueError(f"int8_conv3x3: stride {stride}, pad {pad}")
    if n * ho * wo * cout >= 2 ** 31:
        raise ValueError("int8_conv3x3: the kernel takes fewer than 2^31 "
                         "outputs")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"int8_conv3x3: out dtype {out_dtype}")
    for name, t, size in (("kscale", kscale, cout), ("ascale", ascale, 1),
                          ("bias", bias, cout)):
        if t is not None and (t.dtype != torch.float32 or t.numel() != size
                              or not t.is_contiguous()
                              or (size > 1 and t.data_ptr() % 16)):
            raise ValueError(f"int8_conv3x3: {name} must be {size} "
                             "contiguous float32 values, 16-byte aligned")
    if addend is not None and (
            addend.dtype != torch.float32
            or tuple(addend.shape) != (n, ho, wo, cout)
            or not addend.is_contiguous() or addend.data_ptr() % 16):
        raise ValueError("int8_conv3x3: addend must be a contiguous 16-byte "
                         "aligned float32 (N, Ho, Wo, Cout) = "
                         f"{(n, ho, wo, cout)} tensor")
    if residual is not None and (
            residual.dtype != out_dtype
            or tuple(residual.shape) != (n, ho, wo, cout)
            or not residual.is_contiguous() or residual.data_ptr() % 16):
        raise ValueError(f"int8_conv3x3: residual must be a contiguous "
                         f"16-byte aligned {out_dtype} (N, Ho, Wo, Cout) = "
                         f"{(n, ho, wo, cout)} tensor")
    if not (xq.is_contiguous() and qweight.is_contiguous()) or (
            xq.data_ptr() % 16 or qweight.data_ptr() % 16):
        raise ValueError("int8_conv3x3: xq and qweight must be contiguous "
                         "and 16-byte aligned")
    out = torch.empty((n, ho, wo, cout), dtype=out_dtype, device=xq.device)
    if out.numel() == 0:
        return out
    lib = native.library()
    with torch.cuda.device(xq.device):
        err = lib.btt_int8_conv(
            xq.data_ptr(), qweight.data_ptr(), ascale.data_ptr(),
            kscale.data_ptr(), 0 if bias is None else bias.data_ptr(),
            0 if addend is None else addend.data_ptr(),
            0 if residual is None else residual.data_ptr(), out.data_ptr(),
            int(out_dtype == torch.bfloat16), n, h, w, ho, cin, cout, stride,
            pad[0], pad[1], int(slope is not None),
            0.0 if slope is None else slope, native.stream(xq.device))
    native.check(err, "btt_int8_conv")
    global conv_launches
    conv_launches += 1
    return out


def int8_conv(x: torch.Tensor, qweight: torch.Tensor, kscale: torch.Tensor,
              bias: torch.Tensor | None, stride: int, pad: tuple[int, int],
              act_scale=None, out_dtype: torch.dtype = torch.float32,
              addend: torch.Tensor | None = None, slope: float | None = None,
              residual: torch.Tensor | None = None) -> torch.Tensor:
    """PTQ 3x3 conv on NHWC ``x``: quantize (K3q), then the int8 conv with
    its fp32 epilogue (K3), and the LeakyReLU of ``slope`` and the
    ``residual`` add of ``epilogue_ref`` where given.

    ``act_scale``: the static calibrated activation scale (a float or a
    one-element fp32 tensor on x's device; a tensor spares a host-to-device
    copy per call), or None for the dynamic per-tensor abs-max.  ``addend``
    (fp32, shaped like the output) is added after the bias: the LSTM gate
    conv's h part takes its x part so.  Raises where grad mode is on and an
    input requires grad: it has no backward."""
    _refuse_grad("int8_conv", x, qweight, kscale, bias, act_scale, addend,
                 residual)
    ascale = activation_scale(x, act_scale)
    return int8_conv3x3(quantize_act(x, ascale), qweight, kscale, ascale,
                        bias, stride, pad, out_dtype, addend, slope, residual)


def activation_scale(x: torch.Tensor, act_scale=None,
                     amax: torch.Tensor | None = None) -> torch.Tensor:
    """``int8_conv``'s activation scale as a one-element fp32 tensor on
    x's device: ``act_scale`` where given (a float or such a tensor), else
    the dynamic one, ``amax`` (x's abs-max where None) over 127."""
    if act_scale is None:
        if amax is None:
            amax = x.float().abs().amax()
        return amax.clamp_min(1e-8) / 127.0
    if torch.is_tensor(act_scale):
        return act_scale
    return torch.tensor(act_scale, dtype=torch.float32, device=x.device)
