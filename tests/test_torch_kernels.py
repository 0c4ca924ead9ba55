"""The port's kernels K1 (ConvLSTM gate update) and K2 (input pack) on the
CPU: their plain PyTorch versions against bin_tpu's Pallas kernels (run in
interpret mode) and reference functions, on the same numpy inputs; and the
wrappers' refusal to fall back to a plain version for a non-CPU tensor.

The CUDA kernels themselves run only on a card: ``chip_smoke.py`` holds
them against these plain versions there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bin_tpu.models.convlstm import lstm_gate_math
from bin_tpu.ops.pallas.lstm_gates import fused_lstm_gates as pallas_gates
from bin_tpu.ops.pallas.s2d_pack import space_to_depth_pallas
from bin_tpu.ops.pixel_shuffle import space_to_depth as jax_s2d
from bin_tpu_torch.ops import lstm_gates, native, pixel_shuffle


def _gate_inputs(seed, lead=(2, 6, 5), feat=16):
    rng = np.random.default_rng(seed)
    gates = rng.normal(0, 3, lead + (4 * feat,)).astype(np.float32)
    c = rng.normal(0, 1, lead + (feat,)).astype(np.float32)
    return gates, c


@pytest.mark.parametrize("bias", [1.0, 0.0])
def test_k1_plain_matches_pallas_and_reference_fp32(bias):
    gates, c = _gate_inputs(0)
    h_t, c_t = lstm_gates.lstm_gate_math_ref(torch.from_numpy(gates),
                                             torch.from_numpy(c), bias)
    h_p, c_p = pallas_gates(jnp.asarray(gates), jnp.asarray(c), bias, True)
    h_r, c_r = lstm_gate_math(jnp.asarray(gates), jnp.asarray(c), bias)
    for ours, theirs in ((h_t, h_p), (c_t, c_p), (h_t, h_r), (c_t, c_r)):
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs),
                                   rtol=0, atol=1e-6)


def test_k1_plain_from_bf16_gates():
    """bf16 gates, fp32 cell: both sides round the same fp32 values to bf16
    and do the math in fp32, so fp32 tolerance holds."""
    gates, c = _gate_inputs(1)
    g_t = torch.from_numpy(gates).to(torch.bfloat16)
    h_t, c_t = lstm_gates.lstm_gate_math_ref(g_t, torch.from_numpy(c))
    assert h_t.dtype == c_t.dtype == torch.float32
    g_j = jnp.asarray(gates).astype(jnp.bfloat16)
    h_p, c_p = pallas_gates(g_j, jnp.asarray(c), 1.0, True)
    h_r, c_r = lstm_gate_math(g_j, jnp.asarray(c))
    for ours, theirs in ((h_t, h_p), (c_t, c_p), (h_t, h_r), (c_t, c_r)):
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs),
                                   rtol=0, atol=1e-6)


def test_k1_wrapper_takes_plain_version_on_cpu():
    gates, c = _gate_inputs(2)
    g, cc = torch.from_numpy(gates), torch.from_numpy(c)
    before = lstm_gates.launches
    out = lstm_gates.fused_lstm_gates(g, cc)
    ref = lstm_gates.lstm_gate_math_ref(g, cc)
    assert all(torch.equal(a, b) for a, b in zip(out, ref))
    assert lstm_gates.launches == before  # no kernel ran


def _x(shape, dtype, seed=0):
    rng = np.random.default_rng(seed)
    if dtype == "uint8":
        return rng.integers(0, 256, shape).astype(np.uint8)
    return rng.uniform(-0.5, 1.5, shape).astype(np.float32)


def _to_torch(x, dtype):
    t = torch.from_numpy(x)
    return t.to(torch.bfloat16) if dtype == "bfloat16" else t


def _to_jax(x, dtype):
    return jnp.asarray(x).astype(jnp.dtype(dtype))


@pytest.mark.parametrize("factor", [1, 2, 4])
@pytest.mark.parametrize("dtype", ["uint8", "bfloat16", "float32"])
def test_k2_plain_bit_exact_vs_pallas_and_reference(factor, dtype):
    x = _x((2, 3, 16, 24, 3), dtype)
    ours = pixel_shuffle.space_to_depth_ref(_to_torch(x, dtype), factor)
    wrapped = pixel_shuffle.space_to_depth(_to_torch(x, dtype), factor)
    pallas = space_to_depth_pallas(_to_jax(x, dtype), factor, True)
    ref = jax_s2d(_to_jax(x, dtype), factor)
    assert tuple(ours.shape) == pallas.shape == ref.shape
    got = ours.float().numpy()  # bf16 -> fp32 is exact
    assert np.array_equal(got, np.asarray(pallas).astype(np.float32))
    assert np.array_equal(got, np.asarray(ref).astype(np.float32))
    assert torch.equal(wrapped, ours)


def _emulate_k2(x: np.ndarray, f: int, word: int) -> np.ndarray:
    """csrc/s2d_pack.cu's index math over words of ``word`` bytes, in numpy:
    output row orow, word p of that row."""
    *lead, h, w, c = x.shape
    ho, wo = h // f, w // f
    run = f * c * x.itemsize // word
    words = x.reshape(-1).view(np.dtype(f"V{word}"))
    orow, p = np.meshgrid(np.arange(int(np.prod(lead)) * ho),
                          np.arange(wo * f * run), indexing="ij")
    t, r = p // run, p % run
    xo, dy = t // f, t % f
    n, yo = orow // ho, orow % ho
    irow = n * ho * f + yo * f + dy
    out = words[((irow * wo + xo) * run + r).reshape(-1)]
    return out.view(x.dtype).reshape(*lead, ho, wo, f * f * c)


@pytest.mark.parametrize("dtype", [np.uint8, np.int16, np.float32])
@pytest.mark.parametrize("f,c", [(2, 3), (4, 3), (3, 2), (2, 4)])
def test_k2_index_math_every_word_size(dtype, f, c):
    """The kernel copies runs of f*C elements as the widest word that
    divides them; its index math gives the plain version at every word."""
    x = np.random.default_rng(4).integers(0, 100, (2, 3, 12, 24, c)).astype(dtype)
    want = pixel_shuffle.space_to_depth_ref(torch.from_numpy(x), f).numpy()
    run_bytes = f * c * x.itemsize
    words = [wd for wd in (1, 2, 4, 8, 16) if run_bytes % wd == 0]
    assert pixel_shuffle.word_bytes(run_bytes, 256, 512) == words[-1]
    for word in words:
        assert np.array_equal(_emulate_k2(x, f, word), want), word


def test_k2_word_follows_alignment():
    assert pixel_shuffle.word_bytes(12, 256, 256) == 4
    assert pixel_shuffle.word_bytes(24, 256, 256) == 8
    assert pixel_shuffle.word_bytes(48, 256, 256) == 16
    assert pixel_shuffle.word_bytes(48, 256, 258) == 2
    assert pixel_shuffle.word_bytes(6, 256, 256) == 2
    assert pixel_shuffle.word_bytes(3, 256, 256) == 1


def test_k2_identity_and_divisibility():
    x = torch.ones(1, 8, 8, 3)
    assert pixel_shuffle.space_to_depth(x, 1) is x
    for fn in (pixel_shuffle.space_to_depth, pixel_shuffle.space_to_depth_ref):
        with pytest.raises(ValueError):
            fn(x, 3)
    with pytest.raises(ValueError):
        space_to_depth_pallas(jnp.ones((1, 8, 8, 3)), 3)


def test_k2_inverse_is_depth_to_space():
    x = torch.from_numpy(_x((2, 12, 8, 5), "float32"))
    assert torch.equal(pixel_shuffle.depth_to_space(
        pixel_shuffle.space_to_depth(x, 4), 4), x)


@pytest.fixture
def claims_cuda(monkeypatch):
    """Tensors that report CUDA on a machine without a GPU (meta tensors
    carry shapes and dtypes but no data)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))


def test_cuda_tensor_without_gpu_raises_not_falls_back(claims_cuda):
    gates = torch.empty(1, 4, 4, 64, device="meta", dtype=torch.bfloat16)
    c = torch.empty(1, 4, 4, 16, device="meta")
    with pytest.raises(RuntimeError, match="CUDA device"):
        lstm_gates.fused_lstm_gates(gates, c)
    x = torch.empty(1, 8, 8, 3, device="meta", dtype=torch.bfloat16)
    with pytest.raises(RuntimeError, match="CUDA device"):
        pixel_shuffle.space_to_depth(x, 2)
    with pytest.raises(RuntimeError, match="CUDA device"):
        native.library()


@pytest.mark.parametrize("case", ["nchw_gates", "fp16_gates", "bf16_cell",
                                  "shape", "cpu_cell"])
def test_k1_wrapper_rejects_what_the_kernel_does_not_take(claims_cuda, case):
    gates = torch.empty(1, 4, 4, 64, device="meta", dtype=torch.bfloat16)
    c = torch.empty(1, 4, 4, 16, device="meta")
    if case == "nchw_gates":  # NCHW-contiguous, viewed as NHWC
        gates = torch.empty(1, 64, 4, 4, device="meta",
                            dtype=torch.bfloat16).permute(0, 2, 3, 1)
    elif case == "fp16_gates":
        gates = gates.half()
    elif case == "bf16_cell":
        c = c.bfloat16()
    elif case == "shape":
        c = torch.empty(1, 4, 4, 15, device="meta")
    elif case == "cpu_cell":
        c = torch.empty(1, 4, 4, 16)
    with pytest.raises(ValueError):
        lstm_gates.fused_lstm_gates(gates, c)


@pytest.mark.parametrize("case", ["float16", "non_contiguous"])
def test_k2_wrapper_rejects_what_the_kernel_does_not_take(claims_cuda, case):
    x = torch.empty(1, 8, 8, 3, device="meta", dtype=torch.bfloat16)
    x = x.half() if case == "float16" else x.transpose(1, 2)
    with pytest.raises(ValueError):
        pixel_shuffle.space_to_depth(x, 2)


def test_non_cpu_non_cuda_tensor_raises():
    gates = torch.empty(1, 4, 4, 64, device="meta")
    c = torch.empty(1, 4, 4, 16, device="meta")
    with pytest.raises(ValueError):
        lstm_gates.fused_lstm_gates(gates, c)
    with pytest.raises(ValueError):
        pixel_shuffle.space_to_depth(torch.empty(1, 8, 8, 3, device="meta"), 2)
