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


# ------------------------------------------------------------ K3 emulation

def _k3_tiling() -> dict:
    """The shipped tiling: the K3_* defaults of csrc/int8_conv.cu."""
    src = (pathlib.Path(quant.__file__).parent.parent / "csrc"
           / "int8_conv.cu").read_text()
    return {k: int(v) for k, v in re.findall(r"#define K3_(\w+) (\d+)", src)}


_T = _k3_tiling()
BM, BN, BK = _T["BM"], _T["BN"], _T["BK"]
WARPS_M, WARPS_N = _T["WARPS_M"], _T["WARPS_N"]
THREADS = 32 * WARPS_M * WARPS_N
PIECES = BK // 16                 # 16-byte pieces of a row
ROWS = THREADS // PIECES          # rows a pass of the threads loads
MI, NJ = BM // WARPS_M // 16, BN // WARPS_N // 8


def _emulate_k3(xq: np.ndarray, wq: np.ndarray, stride: int,
                pad: tuple) -> np.ndarray:
    """csrc/int8_conv.cu's int8_conv_kernel in numpy at its shipped tiling,
    for its int32 sums: the grid of BM x BN tiles; each thread's 16-byte A
    and B pieces per K chunk of BK (row t/PIECES + ROWS i, column
    t%PIECES), with the incremental (tap, channel) of its k and the zero
    fill of out-of-range taps, rows past M, columns past Cout and k past K;
    the ldmatrix addresses of the WARPS_M x WARPS_N warps; mma.sync
    m16n8k32's fragment layout; and the epilogue's (row, column) of each
    accumulator, each output written once."""
    n, h, w, cin = xq.shape
    cout = wq.shape[0]
    assert cin % 32 == 0 and cout % 8 == 0
    ho, wo = -(-h // stride), -(-w // stride)
    m_total, k_total = n * ho * wo, 9 * cin
    x_flat, w_flat = xq.reshape(-1), wq.reshape(cout, k_total)
    out = np.zeros((m_total, cout), np.int64)
    hits = np.zeros((m_total, cout), np.int64)
    tid = np.arange(THREADS)
    lrow, lcol = tid // PIECES, (tid % PIECES) * 16
    lane = np.arange(32)
    g, tg = lane // 4, lane % 4
    for m0 in range(0, m_total, BM):
        for n0 in range(0, cout, BN):
            # per-thread loader state
            rows = [lrow + ROWS * i for i in range(BM // ROWS)]
            a_info = []
            for r in rows:
                m = m0 + r
                ok = m < m_total
                mm = np.where(ok, m, 0)
                img, rem = mm // (ho * wo), mm % (ho * wo)
                a_info.append((ok, img, rem // wo * stride - pad[0],
                               rem % wo * stride - pad[1]))
            kload = lcol.copy()
            tap, chan = lcol // cin, lcol % cin
            acc = np.zeros((WARPS_M * WARPS_N, MI, NJ, 32, 4), np.int64)
            for _ in range(-(-k_total // BK)):
                sa = np.zeros((BM, BK), np.int8)
                sb = np.zeros((BN, BK), np.int8)
                kin = kload < k_total
                kh, kw = tap // 3, tap % 3
                for i, r in enumerate(rows):
                    ok_m, img, iy0, ix0 = a_info[i]
                    iy, ix = iy0 + kh, ix0 + kw
                    ok = ok_m & kin & (iy >= 0) & (iy < h) & (ix >= 0) & (ix < w)
                    src = ((img * h + iy) * w + ix) * cin + chan
                    for t in np.nonzero(ok)[0]:
                        sa[r[t], lcol[t]:lcol[t] + 16] = \
                            x_flat[src[t]:src[t] + 16]
                for r in (lrow + ROWS * i for i in range(BN // ROWS)):
                    co = n0 + r
                    okb = (co < cout) & kin
                    for t in np.nonzero(okb)[0]:
                        sb[r[t], lcol[t]:lcol[t] + 16] = \
                            w_flat[co[t], kload[t]:kload[t] + 16]
                kload = kload + BK
                chan = chan + BK
                while (chan >= cin).any():
                    wrap = chan >= cin
                    chan[wrap] -= cin
                    tap[wrap] += 1
                for warp in range(WARPS_M * WARPS_N):
                    wm, wn = warp // WARPS_N, warp % WARPS_N
                    for ks in range(0, BK, 32):
                        af = []  # ldmatrix.x4 of A: 4 regs of 4 bytes a lane
                        for mi in range(MI):
                            arow = wm * MI * 16 + mi * 16 + (lane % 16)
                            acol = ks + (lane // 16) * 16
                            mats = [sa[arow[8 * j:8 * j + 8][:, None],
                                       acol[8 * j:8 * j + 8][:, None]
                                       + np.arange(16)] for j in range(4)]
                            af.append(np.stack(
                                [mats[j][g[:, None], tg[:, None] * 4 + np.arange(4)]
                                 for j in range(4)], axis=1))  # lane, reg, 4
                        bf = {}
                        for nj in range(0, NJ, 2):
                            brow = wn * NJ * 8 + (nj + lane // 16) * 8 + lane % 8
                            bcol = ks + ((lane // 8) % 2) * 16
                            mats = [sb[brow[8 * j:8 * j + 8][:, None],
                                       bcol[8 * j:8 * j + 8][:, None]
                                       + np.arange(16)] for j in range(4)]
                            regs = [mats[j][g[:, None], tg[:, None] * 4 + np.arange(4)]
                                    for j in range(4)]
                            bf[nj] = (regs[0], regs[1])
                            bf[nj + 1] = (regs[2], regs[3])
                        for mi in range(MI):
                            for nj in range(NJ):
                                acc[warp, mi, nj] += _mma_m16n8k32(
                                    af[mi], bf[nj])
            # epilogue
            for warp in range(WARPS_M * WARPS_N):
                wm, wn = warp // WARPS_N, warp % WARPS_N
                for mi in range(MI):
                    for nj in range(NJ):
                        col = n0 + wn * NJ * 8 + nj * 8 + tg * 2
                        for half in range(2):
                            m = m0 + wm * MI * 16 + mi * 16 + g + half * 8
                            for c in range(2):
                                keep = (col < cout) & (m < m_total)
                                out[m[keep], col[keep] + c] += \
                                    acc[warp, mi, nj][keep, 2 * half + c]
                                hits[m[keep], col[keep] + c] += 1
    assert (hits == 1).all()
    return out.reshape(n, ho, wo, cout)


_L, _R, _J = np.meshgrid(np.arange(32), np.arange(4), np.arange(4),
                         indexing="ij")  # lane, register, byte


def _mma_m16n8k32(a_regs: np.ndarray, b_regs: tuple) -> np.ndarray:
    """mma.sync.m16n8k32.row.col s8 per the PTX fragment layout: lane l
    (g = l/4, t = l%4) holds A[g + 8(r%2)][16(r/2) + 4t + j] in a-reg r,
    B[16r + 4t + j][g] in b-reg r, and C[g + 8(r/2)][2t + r%2] in c-reg r.
    Returns the (lane, 4) int32 sums of the 16x8 tile."""
    g, t = _L // 4, _L % 4
    a = np.zeros((16, 32), np.int64)
    a[g + 8 * (_R % 2), 16 * (_R // 2) + 4 * t + _J] = a_regs
    b = np.zeros((32, 8), np.int64)
    b[16 * _R[:, :2] + 4 * t[:, :2] + _J[:, :2], g[:, :2]] = np.stack(
        b_regs, axis=1)
    c = a @ b
    lanes = np.arange(32)[:, None]
    regs = np.arange(4)[None, :]
    return c[lanes // 4 + 8 * (regs // 2), 2 * (lanes % 4) + regs % 2]


@pytest.mark.parametrize("shape,cout,stride", [
    ((1, 6, 7, 32), 8, 1),      # K = 288: a ragged last K chunk; taps out
    ((2, 9, 11, 96), 136, 2),   # odd sizes, a ragged N tile, K = 864
    ((1, 12, 14, 64), 16, 2),   # even sizes at stride 2: padding (0, 1)
    ((3, 5, 10, 128), 24, 1),   # M = 150: a ragged second M tile
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
              addend=None)
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
    return (xq, qw, ks, sc), kw


@pytest.mark.parametrize("case", ["cin_48", "cout_12", "non_contiguous",
                                  "float_x", "stride_3", "addend_shape",
                                  "fp16_out"])
def test_k3_wrapper_rejects_what_the_kernel_does_not_take(claims_cuda, case):
    (xq, qw, ks, sc), kw = _meta_conv_args(case)
    with pytest.raises(ValueError):
        quant.int8_conv3x3(xq, qw, ks, sc, kw["bias"], kw["stride"],
                           kw["pad"], kw["out_dtype"], kw["addend"])


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
