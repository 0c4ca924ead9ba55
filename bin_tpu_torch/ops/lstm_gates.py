"""ConvLSTM gate update: the CUDA kernels K1 (forward) and K1b (backward)
and their plain PyTorch versions.

Counterpart of ``bin_tpu/ops/pallas/lstm_gates.py`` (the Pallas kernel and
its ``custom_vjp``) and of ``bin_tpu.models.convlstm.lstm_gate_math`` (the
function it computes).  The kernels are ``bin_tpu_torch/csrc/lstm_gates.cu``.
``FusedLSTMGates`` is the autograd function on both devices: it saves only
the inputs (gates, c), and its backward recomputes the gate nonlinearities
from them, as ``bin_tpu``'s ``_bwd`` does.
"""

from __future__ import annotations

import torch

from bin_tpu_torch.ops import native

__all__ = ["fused_lstm_gates", "fused_lstm_gates_bwd", "lstm_gate_math_ref",
           "lstm_gates_bwd_ref", "FusedLSTMGates", "k1_plan", "launches",
           "bwd_launches"]

launches = 0      # K1 launches by fused_lstm_gates
bwd_launches = 0  # K1b launches by fused_lstm_gates_bwd

THREADS = 256      # K1's and K1b's block size
MIN_ITEMS = 1 << 17  # items below which V narrows: half the H100's threads


def k1_plan(rows: int, feat: int, dtype: torch.dtype, gate_ptrs=(),
            state_ptrs=()) -> dict:
    """How K1 and K1b cut (rows, F) into the items of their threads.

    A thread takes a run of ``vec`` consecutive features of one row (an
    item) and moves each of the run's blocks in one access: 16 bytes of
    each fp32 tensor at ``vec`` = 4, and 16 bytes of fp32 gates or 8 of
    bf16 ones.  ``vec`` is the widest of 4, 2 and 1 that divides ``feat``,
    leaves at least ``MIN_ITEMS`` items (a small tensor is spread over more
    threads), and to whose access width every address of ``gate_ptrs``
    (the gate-typed tensors, ``dtype``) and ``state_ptrs`` (the fp32 ones)
    is aligned.  Returns {"vec", "threads", "items", "blocks"}: ``blocks``
    is what the items need; the kernel's grid is the smaller of that and
    a few times what the card holds at once, each thread striding over the
    items."""
    size = torch.empty((), dtype=dtype).element_size()
    vec = 4
    while vec > 1 and (
            feat % vec or rows * feat // vec < MIN_ITEMS
            or any(p % (vec * size) for p in gate_ptrs)
            or any(p % (vec * 4) for p in state_ptrs)):
        vec //= 2
    items = rows * (feat // vec)
    return {"vec": vec, "threads": THREADS, "items": items,
            "blocks": -(-items // THREADS)}


def lstm_gate_math_ref(gates: torch.Tensor, c: torch.Tensor,
                       forget_bias: float = 1.0):
    """(..., 4F) gate pre-activations, ordered i, f, g, o, and the (..., F)
    cell -> (h', c') in fp32."""
    gates = gates.float()
    c = c.float()
    i, f, g, o = gates.chunk(4, dim=-1)
    new_c = torch.sigmoid(f + forget_bias) * c + torch.sigmoid(i) * torch.tanh(g)
    new_h = torch.sigmoid(o) * torch.tanh(new_c)
    return new_h, new_c


def lstm_gates_bwd_ref(gates: torch.Tensor, c: torch.Tensor,
                       dh: torch.Tensor, dc_out: torch.Tensor,
                       forget_bias: float = 1.0):
    """The VJP of ``lstm_gate_math_ref`` recomputed from its inputs
    (``bin_tpu/ops/pallas/lstm_gates.py`` ``_bwd``): cotangents dh, dc_out
    of (h', c') -> (dgates in gates' dtype, dc in fp32)."""
    dtype = gates.dtype
    gates = gates.float()
    c = c.float()
    i, f, g, o = gates.chunk(4, dim=-1)
    si = torch.sigmoid(i)
    sf = torch.sigmoid(f + forget_bias)
    tg = torch.tanh(g)
    new_c = sf * c + si * tg
    so = torch.sigmoid(o)
    tc = torch.tanh(new_c)
    # dL/dc' combines the direct cotangent and the one through h'
    dnew_c = dc_out + dh * so * (1.0 - tc * tc)
    di = dnew_c * tg * si * (1.0 - si)
    df = dnew_c * c * sf * (1.0 - sf)
    dg = dnew_c * si * (1.0 - tg * tg)
    do = dh * tc * so * (1.0 - so)
    return torch.cat([di, df, dg, do], dim=-1).to(dtype), dnew_c * sf


def _check_cuda(name: str, gates: torch.Tensor, c: torch.Tensor,
                *cotangents: torch.Tensor) -> None:
    """Raise unless the tensors are what the kernels take."""
    tensors = (gates, c, *cotangents)
    if not (all(t.is_cuda for t in tensors)
            and len({t.device for t in tensors}) == 1):
        raise ValueError(f"{name}: tensors on "
                         f"{sorted({str(t.device) for t in tensors})}; all "
                         "must be on one CUDA device or all on the CPU")
    feat = c.shape[-1]
    if gates.shape[:-1] != c.shape[:-1] or gates.shape[-1] != 4 * feat:
        raise ValueError(f"{name}: gates {tuple(gates.shape)} do not hold "
                         f"four blocks of c {tuple(c.shape)}")
    if gates.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{name}: gates dtype {gates.dtype}; the kernel "
                         "takes bfloat16 or float32")
    for t in (c, *cotangents):
        if t.dtype != torch.float32 or t.shape != c.shape:
            raise ValueError(f"{name}: c and the cotangents must be float32 "
                             f"{tuple(c.shape)}, got {t.dtype} "
                             f"{tuple(t.shape)}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: gates, c and the cotangents must be "
                         "contiguous (..., C) tensors (channels_last)")


def _k1(gates: torch.Tensor, c: torch.Tensor, forget_bias: float):
    """Launch K1 on CUDA tensors that ``fused_lstm_gates`` checked."""
    h_new = torch.empty_like(c)
    c_new = torch.empty_like(c)
    if c.numel() == 0:
        return h_new, c_new
    lib = native.library()
    feat = c.shape[-1]
    rows = c.numel() // feat
    plan = k1_plan(rows, feat, gates.dtype, (gates.data_ptr(),),
                   (c.data_ptr(), h_new.data_ptr(), c_new.data_ptr()))
    with torch.cuda.device(c.device):
        err = lib.btt_lstm_gates(
            gates.data_ptr(), int(gates.dtype == torch.bfloat16),
            c.data_ptr(), h_new.data_ptr(), c_new.data_ptr(), rows, feat,
            float(forget_bias), plan["vec"], plan["threads"],
            native.stream(c.device))
    native.check(err, "btt_lstm_gates")
    global launches
    launches += 1
    return h_new, c_new


def fused_lstm_gates_bwd(gates: torch.Tensor, c: torch.Tensor,
                         dh: torch.Tensor, dc_out: torch.Tensor,
                         forget_bias: float = 1.0):
    """``lstm_gates_bwd_ref`` in one pass: the plain version for CPU
    tensors, the kernel K1b for CUDA tensors (or an error, never the plain
    version).  On CUDA: ``gates`` as ``fused_lstm_gates`` takes it; ``c``,
    ``dh``, ``dc_out`` fp32, contiguous, shaped like ``c``.  Returns
    (dgates in gates' dtype, dc fp32)."""
    if all(t.device.type == "cpu" for t in (gates, c, dh, dc_out)):
        return lstm_gates_bwd_ref(gates, c, dh, dc_out, forget_bias)
    _check_cuda("fused_lstm_gates_bwd", gates, c, dh, dc_out)
    dgates = torch.empty_like(gates)
    dc = torch.empty_like(c)
    if c.numel() == 0:
        return dgates, dc
    lib = native.library()
    feat = c.shape[-1]
    rows = c.numel() // feat
    plan = k1_plan(rows, feat, gates.dtype,
                   (gates.data_ptr(), dgates.data_ptr()),
                   (c.data_ptr(), dh.data_ptr(), dc_out.data_ptr(),
                    dc.data_ptr()))
    with torch.cuda.device(c.device):
        err = lib.btt_lstm_gates_bwd(
            gates.data_ptr(), int(gates.dtype == torch.bfloat16),
            c.data_ptr(), dh.data_ptr(), dc_out.data_ptr(),
            dgates.data_ptr(), dc.data_ptr(), rows, feat,
            float(forget_bias), plan["vec"], plan["threads"],
            native.stream(c.device))
    native.check(err, "btt_lstm_gates_bwd")
    global bwd_launches
    bwd_launches += 1
    return dgates, dc


class FusedLSTMGates(torch.autograd.Function):
    """(h', c') = ``lstm_gate_math_ref(gates, c)``: K1 forward and K1b
    backward on CUDA tensors, the plain versions on CPU tensors.  Only the
    inputs are saved; K1's outputs are fresh tensors that no graph holds."""

    @staticmethod
    def forward(ctx, gates, c, forget_bias: float):
        ctx.forget_bias = forget_bias
        ctx.save_for_backward(gates, c)
        if gates.device.type == "cpu" and c.device.type == "cpu":
            return lstm_gate_math_ref(gates, c, forget_bias)
        return _k1(gates, c, forget_bias)

    @staticmethod
    def backward(ctx, dh, dc_out):
        gates, c = ctx.saved_tensors
        dgates, dc = fused_lstm_gates_bwd(
            gates, c, dh.float().contiguous(), dc_out.float().contiguous(),
            ctx.forget_bias)
        return dgates, dc.to(c.dtype), None


def fused_lstm_gates(gates: torch.Tensor, c: torch.Tensor,
                     forget_bias: float = 1.0):
    """``lstm_gate_math_ref`` in one pass, differentiable: the plain
    versions for CPU tensors, the CUDA kernels for CUDA tensors (or an
    error, never the plain version).

    On CUDA: ``gates`` (..., 4F) bf16 or fp32, contiguous, i.e. the
    channels_last output of the gate conv viewed as NHWC; ``c`` (..., F)
    fp32, contiguous.  Returns new (h', c'), fp32, shaped like ``c``; their
    gradient is K1b's."""
    if not (gates.device.type == "cpu" and c.device.type == "cpu"):
        _check_cuda("fused_lstm_gates", gates, c)
    return FusedLSTMGates.apply(gates, c, forget_bias)
