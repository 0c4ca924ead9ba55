"""The port's int8 serving path on the CPU: ``bin_tpu_torch/ops/quant.py``
and the int8 modules against ``bin_tpu`` bit for bit on the same numpy
inputs, the scales sidecar, and a numpy emulation of the CUDA kernel K3's
tiles, loads and fragments (the kernel itself runs only on a card, where
``chip_smoke.py`` holds it against its plain version).

Bit for bit: every step of the scheme is an exact or correctly rounded IEEE
operation (int32 sums, one fp32 division, one fp32 multiply, one fp32 add,
one cast), so the two frameworks agree exactly where their inputs agree.
``bin_tpu`` is run eagerly here, as its source defines the function: under
``jax.jit`` XLA rewrites the division by a static scale into a multiply by
its rounded reciprocal, which moves an activation by one step now and then.
"""

import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from bin_tpu.models.backbone import Backbone as JBackbone
from bin_tpu.models.convlstm import ConvLSTMCell as JCell
from bin_tpu.ops import quant as jq
from bin_tpu_torch import benchmark
from bin_tpu_torch.config import ModelConfig, apply_model_overrides
from bin_tpu_torch.models.backbone import Backbone
from bin_tpu_torch.models.convlstm import ConvLSTMCell, Int8GateConv
from bin_tpu_torch.models.layers import Int8Conv, Upsample, _same_pad
from bin_tpu_torch.models.pyramid import BINPyramid
from bin_tpu_torch.ops import quant
from bin_tpu_torch.weights import load_weights, params_from_flax
from torch_params import random_flax_params

RELEASE = "weights/prf_ema_r4.npz"
SCALES = "weights/prf_ema_r4.scales.npz"


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(0, scale, shape)
            .astype(np.float32))


def _pad(h, w, stride):
    return _same_pad(h, 3, stride)[0], _same_pad(w, 3, stride)[0]


def _packed(kernel_hwio):
    """bin_tpu's kernel (kh, kw, I, O) -> the port's (qweight, kscale)."""
    return quant.quantize_weight(
        torch.from_numpy(np.ascontiguousarray(kernel_hwio.transpose(3, 2, 0, 1))))


@pytest.mark.parametrize("per_channel", [False, True])
def test_quantize_symmetric_matches_bin_tpu(per_channel):
    """Includes a zero channel (the 1e-8 floor) and values on .5 steps."""
    k = _rand((3, 3, 8, 6), 0, 0.1)
    k[..., 2] = 0.0
    k[0, 0, 0, 3], k[1, 1, 1, 3] = 1.27, 0.025  # 0.025 / 0.01 = 2.5: even
    ours_q, ours_s = quant.quantize_symmetric(
        torch.from_numpy(k.transpose(3, 2, 0, 1).copy()),
        dim=(1, 2, 3) if per_channel else None)
    theirs_q, theirs_s = jq.quantize_symmetric(
        jnp.asarray(k), axis=(0, 1, 2) if per_channel else None)
    theirs_q = np.asarray(theirs_q).transpose(3, 2, 0, 1)
    assert np.array_equal(ours_q.numpy(), theirs_q)
    assert np.array_equal(ours_s.numpy().reshape(-1),
                          np.asarray(theirs_s).reshape(-1))
    qw, ks = quant.quantize_weight(torch.from_numpy(
        k.transpose(3, 2, 0, 1).copy()))
    if per_channel:
        assert np.array_equal(qw.numpy(), theirs_q.transpose(0, 2, 3, 1))
        assert np.array_equal(ks.numpy(), np.asarray(theirs_s).reshape(-1))


def test_quantize_weight_refuses_a_cast_weight():
    with pytest.raises(ValueError, match="fp32"):
        quant.quantize_weight(torch.zeros(4, 4, 3, 3, dtype=torch.bfloat16))


CONV_SHAPES = [((2, 8, 10, 32), 16, 1), ((2, 8, 10, 32), 24, 2),
               ((1, 9, 7, 64), 8, 2), ((2, 7, 5, 32), 40, 1)]


@pytest.mark.parametrize("shape,cout,stride", CONV_SHAPES)
def test_int8_conv_ref_int32_sums_match_lax(shape, cout, stride):
    """Even and odd sizes at stride 1 and 2 (flax SAME: (0, 1) padding at
    stride 2 on an even side): the int32 sums of the im2col + _int_mm route
    equal XLA's int8 conv on bin_tpu's quantized operands."""
    x, k = _rand(shape, 1), _rand((3, 3, shape[-1], cout), 2, 0.1)
    qx, ascale = jq.quantize_symmetric(jnp.asarray(x))
    qk, _ = jq.quantize_symmetric(jnp.asarray(k), axis=(0, 1, 2))
    theirs = lax.conv_general_dilated(
        qx, qk, (stride, stride), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.int32)
    qw = torch.from_numpy(np.asarray(qk).transpose(3, 0, 1, 2).copy())
    ours = quant.int8_conv_ref(torch.from_numpy(np.array(qx)), qw, stride,
                               _pad(*shape[1:3], stride))
    assert ours.dtype == torch.int32
    assert np.array_equal(ours.numpy(), np.asarray(theirs))


@pytest.mark.parametrize("shape,cout,stride", CONV_SHAPES)
@pytest.mark.parametrize("act_scale", [None, 0.011])
@pytest.mark.parametrize("with_bias", [True, False])
def test_int8_conv_matches_bin_tpu_bit_for_bit(shape, cout, stride,
                                               act_scale, with_bias):
    """fp32 output bit for bit, static and dynamic activation scale (0.011
    saturates |x| > 1.4), with and without bias; its bf16 cast too."""
    x, k = _rand(shape, 3), _rand((3, 3, shape[-1], cout), 4, 0.1)
    b = _rand((cout,), 5, 0.1) if with_bias else None
    theirs = np.asarray(jq.int8_conv(
        jnp.asarray(x), jnp.asarray(k), None if b is None else jnp.asarray(b),
        (stride, stride), act_scale=act_scale))
    qw, ks = _packed(k)
    bt = None if b is None else torch.from_numpy(b)
    pad = _pad(*shape[1:3], stride)
    ours = quant.int8_conv(torch.from_numpy(x), qw, ks, bt, stride, pad,
                           act_scale)
    assert ours.dtype == torch.float32
    assert np.array_equal(ours.numpy(), theirs)
    ours16 = quant.int8_conv(torch.from_numpy(x), qw, ks, bt, stride, pad,
                             act_scale, torch.bfloat16)
    assert torch.equal(ours16, torch.from_numpy(theirs).to(torch.bfloat16))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("scales", [None, (0.02, 0.009)])
def test_lstm_split_with_addend_matches_bin_tpu(dtype, scales):
    """The gate conv split: conv(x, Kx) + bias in fp32, then conv(h, Kh) in
    addend mode, then the cast; each part with its own scales.  Equal to
    bin_tpu's (int8_conv(x) + int8_conv(h)).astype(dtype) bit for bit."""
    cx, f = 32, 16
    x, h = _rand((1, 6, 7, cx), 6), _rand((1, 6, 7, f), 7, 0.5)
    k, b = _rand((3, 3, cx + f, 4 * f), 8, 0.1), _rand((4 * f,), 9, 0.1)
    jdt = jnp.dtype(dtype)
    sx, sh = scales or (None, None)
    xj, hj = jnp.asarray(x).astype(jdt), jnp.asarray(h).astype(jdt)
    theirs = (jq.int8_conv(xj, jnp.asarray(k[:, :, :cx]), jnp.asarray(b),
                           act_scale=sx)
              + jq.int8_conv(hj, jnp.asarray(k[:, :, cx:]), None,
                             act_scale=sh)).astype(jdt)
    tdt = getattr(torch, dtype)
    xt = torch.from_numpy(x).to(tdt)
    ht = torch.from_numpy(h).to(tdt)
    qx, kx = _packed(k[:, :, :cx])
    qh, kh = _packed(k[:, :, cx:])
    gx = quant.int8_conv(xt, qx, kx, torch.from_numpy(b), 1, (1, 1), sx)
    ours = quant.int8_conv(ht, qh, kh, None, 1, (1, 1), sh, tdt, addend=gx)
    assert ours.dtype == tdt
    assert np.array_equal(ours.float().numpy(),
                          np.asarray(theirs).astype(np.float32))


@pytest.mark.parametrize("scales", [None, {"gates_x": 0.02,
                                           "gates_h": 0.009}])
def test_int8_convlstm_cell_matches_bin_tpu(scales):
    """The cell, fp32, int8 gate conv: two steps of carried state.  The
    gates are bit-exact (above); the gate math's transcendentals differ by
    ~1e-7 between the frameworks, and a state that moves flips a rounding
    of the next step's h now and then, hence 1e-4."""
    x1, x2 = _rand((1, 6, 8, 32), 1), _rand((1, 6, 8, 32), 2)
    ours = ConvLSTMCell(32, 16, quant=True)
    params = random_flax_params(ours)
    if scales:
        ours.gates.act_scales = (scales["gates_x"], scales["gates_h"])
    ours.load_state_dict(params_from_flax(params), strict=True)
    ours.gates.quantize()
    jm = JCell(features=16, quant=True, quant_scales=scales)
    js = (jnp.zeros((1, 6, 8, 16)),) * 2
    ts = (torch.zeros(1, 6, 8, 16),) * 2
    with torch.no_grad():
        for x in (x1, x2):
            js = jm.apply({"params": params}, jnp.asarray(x), js)
            ts = ours(torch.from_numpy(x), ts)
            for o, j in zip(ts, js):
                np.testing.assert_allclose(o.numpy(), np.asarray(j), rtol=0,
                                           atol=1e-4)


def test_int8_backbone_bottleneck_bit_exact():
    """Every 3x3 conv of the encoder and bottleneck int8 (min Cin 0), fp32,
    no context: the bottleneck features equal bin_tpu's bit for bit (the
    int8 convs, LeakyReLU and residual adds are exact), and the output is
    close (the float upsamples sum in another order and may flip a
    rounding of the decoder's int8 input)."""
    a, b = _rand((2, 8, 12, 12), 1), _rand((2, 8, 12, 12), 2)
    ours = Backbone(8, (1, 2, 4), 1, 0.1, 2, quant=True, quant_min_cin=0)
    params = random_flax_params(ours)
    jm = JBackbone(base_features=8, num_res_blocks=1, stem_factor=2,
                   conv_int8=True)
    sharp_j, feats_j = jm.apply({"params": params}, jnp.asarray(a),
                                jnp.asarray(b))
    ours.load_state_dict(params_from_flax(params), strict=True)
    for m in ours.modules():
        if isinstance(m, Int8Conv):
            m.quantize()
        elif isinstance(m, Upsample):
            m.prepare()
    with torch.no_grad():
        sharp_t, feats_t = ours(torch.from_numpy(a), torch.from_numpy(b))
    assert np.array_equal(feats_t.numpy(), np.asarray(feats_j))
    np.testing.assert_allclose(sharp_t.numpy(), np.asarray(sharp_j), rtol=0,
                               atol=1e-3)


def test_serving_scope_and_scale_keys():
    """In the serving mode exactly the convs with Cin >= 256 and the gate
    convs are int8: 13 per level and 2 gate halves, each with its static
    scale from the sidecar under its flax path."""
    _, card, _ = load_weights(RELEASE)
    cfg = apply_model_overrides(card, [*benchmark.SERVING_MODE,
                                       *benchmark.serving_overrides(RELEASE)])
    with torch.device("meta"):
        model = BINPyramid(cfg)
    scales = quant.load_act_scales(SCALES)
    int8 = {}
    for name, m in model.named_modules():
        key = name.replace(".", "/")
        if isinstance(m, Int8Conv):
            int8[key] = m.act_scale
            assert m.in_channels >= 256
        elif isinstance(m, Int8GateConv):
            int8[key + "_x"], int8[key + "_h"] = m.act_scales
        elif isinstance(m, torch.nn.Conv2d) and m.kernel_size == (3, 3):
            assert m.in_channels < 256 or "up_" in key, key
    assert len(int8) == 3 * 13 + 3 * 2
    assert int8 == {k: scales[k] for k in int8}
    assert all(k.split("/")[1] in ("enc_1", "down_1", "dec_1", "gates_x",
                                   "gates_h") or k.split("/")[1]
               .startswith("mid_") for k in int8)


def test_lookup_act_scale_is_strict():
    with pytest.raises(KeyError, match="level_9/mid_0/Conv_0"):
        quant.lookup_act_scale({"level_1/mid_0/Conv_0": 0.1},
                               "level_9/mid_0/Conv_0")
    with pytest.raises(KeyError):
        jq.lookup_act_scale({"level_1/mid_0/Conv_0": 0.1},
                            "level_9/mid_0/Conv_0")


def test_missing_scale_key_raises_when_the_model_is_built(tmp_path):
    path = tmp_path / "partial.scales.npz"
    full = quant.load_act_scales(SCALES)
    np.savez(path, **{k: np.float32(v) for k, v in full.items()
                      if k != "lstm_2/gates_h"})
    cfg = ModelConfig(name="prf", base_features=128, conv_int8=True,
                      conv_int8_min_cin=256, conv_int8_lstm=True,
                      conv_int8_static=str(path))
    with torch.device("meta"), pytest.raises(KeyError, match="lstm_2/gates_h"):
        BINPyramid(cfg)


def test_scales_sidecar_skips_dunder_keys_as_bin_tpu(tmp_path):
    path = tmp_path / "w.scales.npz"
    np.savez(path, **{"level_1/mid_0/Conv_0": np.float32(0.0123),
                      "lstm_1/gates_x": np.float32(0.5),
                      "__calibrated_for__": np.array("w.npz")})
    ours, theirs = quant.load_act_scales(str(path)), jq.load_act_scales(
        str(path))
    assert ours == theirs == {"level_1/mid_0/Conv_0": float(np.float32(0.0123)),
                              "lstm_1/gates_x": 0.5}
    assert quant.scales_calibrated_for(str(path)) == "w.npz" == \
        jq.scales_calibrated_for(str(path))
    assert quant.scales_calibrated_for(SCALES) is None
    assert quant.scales_calibrated_for(str(tmp_path / "none.npz")) is None
    release = quant.load_act_scales(SCALES)
    assert release == jq.load_act_scales(SCALES) and len(release) == 63


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("slope,with_residual", [(0.1, False), (None, True),
                                                 (0.1, True)])
def test_epilogue_args_equal_the_eager_sequence(dtype, slope, with_residual):
    """K3's plain version with ``slope`` and ``residual`` equals the eager
    sequence the blocks ran before: the conv, then ``F.leaky_relu``, then
    ``residual +``, bit for bit."""
    x = torch.from_numpy(_rand((2, 7, 9, 32), 21)).to(dtype)
    sc = torch.tensor(0.013)
    qw, ks = _packed(_rand((3, 3, 32, 24), 22, 0.1))
    bias = torch.from_numpy(_rand((24,), 23, 0.1))
    residual = (torch.from_numpy(_rand((2, 7, 9, 24), 24)).to(dtype)
                if with_residual else None)
    xq = quant.quantize_act(x, sc)
    eager = quant.int8_conv3x3_ref(xq, qw, ks, sc, bias, 1, (1, 1), dtype)
    if slope is not None:
        eager = torch.nn.functional.leaky_relu(eager, slope)
    if residual is not None:
        eager = residual + eager
    ours = quant.int8_conv3x3(xq, qw, ks, sc, bias, 1, (1, 1), dtype,
                              slope=slope, residual=residual)
    assert ours.dtype == dtype and torch.equal(ours, eager)
    whole = quant.int8_conv(x, qw, ks, bias, 1, (1, 1), sc, dtype,
                            slope=slope, residual=residual)
    assert torch.equal(whole, eager)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("quant_on", [True, False])
@pytest.mark.parametrize("block", ["ConvBlock", "Downsample", "ResBlock"])
def test_blocks_pass_their_epilogue_to_the_conv(block, quant_on, dtype):
    """ConvBlock, Downsample and ResBlock hand their LeakyReLU and skip add
    to the conv; the result equals the eager sequence they ran before
    (``F.leaky_relu(conv(x))``; ``x + conv_1(F.leaky_relu(conv_0(x)))``)
    bit for bit, int8 or float, fp32 or bf16."""
    from bin_tpu_torch.models import layers

    cls = getattr(layers, block)
    m = (cls(32, quant=quant_on) if block == "ResBlock"
         else cls(32, 48, quant=quant_on))
    m.load_state_dict(params_from_flax(random_flax_params(m)), strict=True)
    for conv in m.modules():
        if isinstance(conv, Int8Conv):
            conv.quantize()
    m = m.to(dtype)
    x = torch.from_numpy(_rand((2, 10, 12, 32), 25)).to(dtype)
    lrelu = torch.nn.functional.leaky_relu
    with torch.no_grad():
        ours = m(x)
        if block == "ResBlock":
            before = x + m.Conv_1(lrelu(m.Conv_0(x), m.slope))
        else:
            before = lrelu(m.Conv_0(x), m.slope)
    assert isinstance(m.Conv_0, Int8Conv) == quant_on
    assert ours.dtype == dtype and torch.equal(ours, before)


# ------------------------------------------------------------ K3 emulation

_SRC = (pathlib.Path(quant.__file__).parent.parent / "csrc"
        / "int8_conv.cu").read_text()


def _k3_tiling() -> dict:
    """The shipped tiling: the K3_* defaults of csrc/int8_conv.cu, its
    shared-memory limit and the epilogue's staging."""
    t = {k: int(v) for k, v in re.findall(r"#define K3_(\w+) (\d+)", _SRC)}
    for name in ("BN", "SMEM_LIMIT", "EPI_COLS", "EPI_PITCH"):
        t[name] = int(re.search(r"\b" + name + r" = (\d+)", _SRC).group(1))
    return t


_T = _k3_tiling()
BH, BW, BN = _T["BH"], _T["BW"], _T["BN"]
BM = BH * BW
SLABS = BM // 64                  # m64 wgmmas a k-step
EPI_COLS, EPI_PITCH = _T["EPI_COLS"], _T["EPI_PITCH"]


def _k3_plan(cin: int) -> tuple:
    """(CK, STAGES) as ``btt_int8_conv`` and ``Tiling`` choose them: the
    widest chunk of 128, 64, 32 bytes dividing Cin; as many stages as fit
    beside the two consumers' staging, at most K3_MAX_STAGES."""
    ck = 128 if cin % 128 == 0 else 64 if cin % 64 == 0 else 32
    staging = 2 * 64 * EPI_PITCH * 4
    fit = ((_T["SMEM_LIMIT"] - 1024 - 16 - staging - 16 * _T["MAX_STAGES"])
           // (BM * ck + BN * ck))
    return ck, min(fit, _T["MAX_STAGES"])


def _swizzle(addr, ck: int):
    """TMA's swizzle of CK bytes, on shared-memory byte addresses (the ring
    starts on the 1024-byte repeat): the 16-byte chunk index, bits 4 and
    up, XOR bits 7 and up, over 3, 2 or 1 bits for 128, 64 or 32 bytes."""
    mask = {128: 7, 64: 3, 32: 1}[ck]
    return addr ^ (((addr >> 7) & mask) << 4)


def _tma_box(smem, dst, src, coords, dims, box, strides, ck):
    """cp.async.bulk.tensor of one box: element (i0, i1, ...) of the box is
    the source at coords + i * strides (out of range, negative included,
    reads zero), stored densely (i0 fastest) from ``dst`` under the
    swizzle."""
    idx = np.meshgrid(*[c + s * np.arange(b) for c, s, b in
                        zip(coords, strides, box)], indexing="ij")
    ok = np.ones(idx[0].shape, bool)
    for i, d in zip(idx, dims):
        ok &= (i >= 0) & (i < d)
    vals = np.where(ok, src[tuple(np.where(ok, i, 0) for i in idx[::-1])], 0)
    # dense order: dimension 0 fastest
    flat = vals.transpose(*range(len(box))[::-1]).reshape(-1)
    smem[_swizzle(dst + np.arange(flat.size), ck)] = flat


def _desc_read(smem, start, rows, ck):
    """The (rows, 32) bytes a wgmma descriptor names: K-major, row r at
    start + (r // 8) SBO + (r % 8) CK with SBO = 8 CK, then the swizzle."""
    r = np.arange(rows)[:, None]
    addr = start + (r // 8) * 8 * ck + (r % 8) * ck + np.arange(32)[None]
    return smem[_swizzle(addr, ck)].view(np.int8).astype(np.int64)


_LANE = np.arange(128) % 32
_WARP = np.arange(128) // 32


def _fragment(bn: int):
    """wgmma m64nNk32's s32 fragment: thread t's register 4j + 2h + e holds
    row 16 (t / 32) + (t % 32) / 4 + 8h and column 8j + 2 (t % 4) + e."""
    reg = np.arange(bn // 2)[None]
    row = 16 * _WARP[:, None] + _LANE[:, None] // 4 + 8 * ((reg // 2) % 2)
    col = 8 * (reg // 4) + 2 * (_LANE[:, None] % 4) + reg % 2
    return row, col


_CT = np.arange(128)
_C4, _R8 = _CT % 16, _CT // 16   # the coalesced phase's place


def _epilogue(acc, row, col, row0, tile, size, out, hits):
    """The epilogue of one 64-row slab: for each pass, the fragment
    (thread, register) -> staging (row, column of the pass); then thread
    t reads columns 4 (t % 16) + e of rows t / 16 + 8 i, the tile's pixel
    row0 + row and channel n0 + pass EPI_COLS + 4 (t % 16) + e."""
    b, oy0, ox0, n0 = tile
    ho, wo, cout = size
    for pas in range(acc.shape[1] * 2 // EPI_COLS):
        staging = np.zeros((64, EPI_PITCH), np.int64)
        filled = np.zeros((64, EPI_PITCH), np.int64)
        sel = col // EPI_COLS == pas
        np.add.at(staging, (row[sel], col[sel] % EPI_COLS), acc[sel])
        np.add.at(filled, (row[sel], col[sel] % EPI_COLS), 1)
        assert (filled[:, :EPI_COLS] == 1).all()
        for it in range(64 // 8):
            r = _R8 + 8 * it
            tr = row0 + r
            oy, ox = oy0 + tr // BW, ox0 + tr % BW
            for e in range(4):
                co = n0 + pas * EPI_COLS + 4 * _C4 + e
                keep = (oy < ho) & (ox < wo) & (co < cout)
                out[b, oy[keep], ox[keep], co[keep]] += \
                    staging[r[keep], 4 * _C4[keep] + e]
                hits[b, oy[keep], ox[keep], co[keep]] += 1


def _emulate_k3(xq: np.ndarray, wq: np.ndarray, stride: int, pad: tuple,
                sms: int = 2) -> np.ndarray:
    """csrc/int8_conv.cu's int8_conv_kernel in numpy, for its int32 sums,
    on a card of ``sms`` SMs (few, so that each block walks several tiles
    and its ring wraps across them): the persistent walk, tile k of a
    block to consumer k % 2, which finds its loads at the ring's stage and
    phase of load k kblocks onwards, the consumers taking turns (each
    waits on the next fill of a stage, never one further ahead); per (tile, tap, chunk) the producer's
    two TMA boxes into the stage, with the zero fill of what lies outside
    the input or the weight, under the swizzle; the full/empty protocol
    with the producer as far ahead as the empty barriers let it, each stage
    checked to hold the load a consumer expects when it reads it and still
    to hold it when the wgmma group that read it frees it; each slab's
    wgmma k-steps through their descriptors (+32 bytes a step); and the
    epilogue: per pass of EPI_COLS columns the fragment registers into the
    staging rows, then each thread's four columns of a row out to (pixel,
    channel), each staging slot and each output written once."""
    n, h, w, cin = xq.shape
    cout = wq.shape[0]
    ck, stages = _k3_plan(cin)
    ho, wo = -(-h // stride), -(-w // stride)
    tiles_x, tiles_y, n_tiles = -(-wo // BW), -(-ho // BH), -(-cout // BN)
    tiles = n * tiles_y * tiles_x * n_tiles
    chunks = cin // ck
    kblocks = 9 * chunks
    a_bytes, stage_bytes = BM * ck, BM * ck + BN * ck
    w2 = wq.reshape(cout, 9 * cin)
    row, col = _fragment(BN)
    out = np.zeros((n, ho, wo, cout), np.int64)
    hits = np.zeros(out.shape, np.int64)

    def tile_at(t):
        nt, mt = t % n_tiles, t // n_tiles
        tx, mt = mt % tiles_x, mt // tiles_x
        return mt // tiles_y, (mt % tiles_y) * BH, tx * BW, nt * BN

    for block in range(min(tiles, sms)):
        walk = list(range(block, tiles, sms))
        loads = [(t, kb) for t in walk for kb in range(kblocks)]
        smem = np.zeros(stages * stage_bytes, np.uint8)
        tag = [None] * stages           # which load a stage holds
        fills = [0] * stages            # the full barrier's completed phases
        freed = [False] * len(loads)    # empty barrier arrivals, per load
        nxt = 0                         # the producer's next load

        def produce():
            nonlocal nxt
            while nxt < len(loads) and (nxt < stages or freed[nxt - stages]):
                t, kb = loads[nxt]
                b, oy0, ox0, n0 = tile_at(t)
                tap, c0 = kb // chunks, kb % chunks * ck
                kh, kw = tap // 3, tap % 3
                base = nxt % stages * stage_bytes
                _tma_box(smem, base, xq.view(np.uint8),
                         (c0, ox0 * stride - pad[1] + kw,
                          oy0 * stride - pad[0] + kh, b),
                         (cin, w, h, n), (ck, BW, BH, 1),
                         (1, stride, stride, 1), ck)
                _tma_box(smem, base + a_bytes, w2.view(np.uint8),
                         (tap * cin + c0, n0), (9 * cin, cout), (ck, BN),
                         (1, 1), ck)
                tag[nxt % stages] = nxt
                fills[nxt % stages] += 1
                nxt += 1

        def release(g):
            assert tag[g % stages] == g, "a stage was refilled while read"
            freed[g] = True

        for k, t in enumerate(walk):    # consumer k % 2 takes tile k
            b, oy0, ox0, n0 = tile_at(t)
            stage = k * kblocks % stages
            phase = k * kblocks // stages % 2
            acc = np.zeros((SLABS, 128, BN // 2), np.int64)
            for kb in range(kblocks):
                produce()
                g = k * kblocks + kb
                # the full barrier's wait on (stage, phase) passes
                assert fills[stage] % 2 != phase and tag[stage] == g
                base = stage * stage_bytes
                for ks in range(ck // 32):
                    b_ = _desc_read(smem, base + a_bytes + 32 * ks, BN, ck)
                    for sl in range(SLABS):
                        a = _desc_read(smem, base + sl * 64 * ck + 32 * ks,
                                       64, ck)
                        acc[sl] += (a @ b_.T)[row, col]
                if kb > 0:
                    release(g - 1)  # wgmma.wait_group 1
                stage += 1
                if stage == stages:
                    stage, phase = 0, phase ^ 1
            release(k * kblocks + kblocks - 1)  # wgmma.wait_group 0
            for sl in range(SLABS):
                _epilogue(acc[sl], row, col, 64 * sl, (b, oy0, ox0, n0),
                          (ho, wo, cout), out, hits)
        produce()
        assert nxt == len(loads)
    assert (hits == 1).all()
    return out


@pytest.mark.parametrize("shape,cout,stride", [
    ((1, 6, 7, 32), 8, 1),        # 32-byte chunks; taps out of range
    ((2, 9, 11, 96), 136, 2),     # odd sizes, three 32-byte chunks a tap,
                                  # a ragged N tile
    ((1, 12, 14, 64), 16, 2),     # even sizes at stride 2: padding (0, 1)
    ((3, 5, 10, 128), 24, 1),     # 128-byte chunks; rows past the image
    ((2, 11, 13, 64), 40, 1),     # 64-byte chunks at stride 1, odd sizes
    ((1, 9, 34, 128), 256, 1),    # two N tiles, a ragged column of tiles
    ((1, 10, 70, 256), 512, 2),   # four N tiles at stride 2
    ((1, 9, 20, 64), 24, 1),      # three tiles: a block's consumers take
                                  # an odd number
])
def test_k3_tile_and_padding_index_math(shape, cout, stride):
    rng = np.random.default_rng(11)
    xq = rng.integers(-127, 128, shape, dtype=np.int8)
    wq = rng.integers(-127, 128, (cout, 3, 3, shape[-1]), dtype=np.int8)
    pad = _pad(*shape[1:3], stride)
    want = quant.int8_conv_ref(torch.from_numpy(xq), torch.from_numpy(wq),
                               stride, pad).numpy()
    assert np.array_equal(_emulate_k3(xq, wq, stride, pad), want)


@pytest.fixture
def claims_cuda(monkeypatch):
    """Tensors that report CUDA on a machine without a GPU (meta tensors
    carry shapes and dtypes but no data)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))


def _meta_conv_args(case):
    n, h, w, cin, cout = 1, 6, 6, 64, 16
    xq = torch.empty(n, h, w, cin, dtype=torch.int8, device="meta")
    qw = torch.empty(cout, 3, 3, cin, dtype=torch.int8, device="meta")
    ks = torch.empty(cout, device="meta")
    sc = torch.empty((), device="meta")
    kw = dict(bias=None, stride=1, pad=(1, 1), out_dtype=torch.bfloat16,
              addend=None, slope=None, residual=None)
    if case == "cin_48":
        xq = torch.empty(n, h, w, 48, dtype=torch.int8, device="meta")
        qw = torch.empty(cout, 3, 3, 48, dtype=torch.int8, device="meta")
    elif case == "cout_12":
        qw = torch.empty(12, 3, 3, cin, dtype=torch.int8, device="meta")
        ks = torch.empty(12, device="meta")
    elif case == "non_contiguous":
        xq = torch.empty(n, w, h, cin, dtype=torch.int8,
                         device="meta").transpose(1, 2)
    elif case == "float_x":
        xq = xq.float()
    elif case == "stride_3":
        kw["stride"] = 3
    elif case == "addend_shape":
        kw["addend"] = torch.empty(n, h, w, 8, device="meta")
    elif case == "fp16_out":
        kw["out_dtype"] = torch.float16
    elif case == "residual_dtype":
        kw["residual"] = torch.empty(n, h, w, cout, device="meta")
    elif case == "residual_shape":
        kw["residual"] = torch.empty(n, h, w, 8, dtype=torch.bfloat16,
                                     device="meta")
    elif case == "residual_non_contiguous":
        kw["residual"] = torch.empty(n, w, h, cout, dtype=torch.bfloat16,
                                     device="meta").transpose(1, 2)
    return (xq, qw, ks, sc), kw


@pytest.mark.parametrize("case", ["cin_48", "cout_12", "non_contiguous",
                                  "float_x", "stride_3", "addend_shape",
                                  "fp16_out", "residual_dtype",
                                  "residual_shape",
                                  "residual_non_contiguous"])
def test_k3_wrapper_rejects_what_the_kernel_does_not_take(claims_cuda, case):
    (xq, qw, ks, sc), kw = _meta_conv_args(case)
    with pytest.raises(ValueError):
        quant.int8_conv3x3(xq, qw, ks, sc, kw["bias"], kw["stride"],
                           kw["pad"], kw["out_dtype"], kw["addend"],
                           kw["slope"], kw["residual"])


def test_k3_and_k3q_raise_without_a_card_not_fall_back(claims_cuda):
    (xq, qw, ks, sc), kw = _meta_conv_args("ok")
    with pytest.raises(RuntimeError, match="CUDA device"):
        quant.int8_conv3x3(xq, qw, ks, sc, **kw)
    x = torch.empty(1, 4, 4, 32, dtype=torch.bfloat16, device="meta")
    with pytest.raises(RuntimeError, match="CUDA device"):
        quant.quantize_act(x, sc)
    for bad in (x.half(), x.transpose(1, 2)):
        with pytest.raises(ValueError):
            quant.quantize_act(bad, sc)


def test_wrappers_take_plain_versions_on_cpu():
    x = torch.from_numpy(_rand((1, 5, 6, 32), 12)).to(torch.bfloat16)
    sc = torch.tensor(0.01)
    qw, ks = _packed(_rand((3, 3, 32, 8), 13, 0.1))
    before = (quant.quantize_launches, quant.conv_launches)
    xq = quant.quantize_act(x, sc)
    assert torch.equal(xq, quant.quantize_act_ref(x, sc))
    out = quant.int8_conv3x3(xq, qw, ks, sc, None, 1, (1, 1), torch.float32)
    assert torch.equal(out, quant.int8_conv3x3_ref(xq, qw, ks, sc, None, 1,
                                                   (1, 1), torch.float32))
    assert (quant.quantize_launches, quant.conv_launches) == before
    with pytest.raises(ValueError):
        quant.int8_conv3x3(xq, qw, ks, sc.to("meta"), None, 1, (1, 1),
                           torch.float32)
