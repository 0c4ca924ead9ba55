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


def _emulate_k2(x: np.ndarray, f: int, word: int, cells: int, slice_: int,
                x_addr: int = 0, out_addr: int = 0) -> np.ndarray:
    """csrc/s2d_pack.cu's mapping in numpy, byte for byte, for the plan
    (word, cells, slice_): btt_s2d_pack's checks, the tiles (tile_at), the
    f input segments a tile stages as words (load_tile) and the output words
    gathered from the stage in pieces (store_tile).  Checks each global
    access against its word's alignment, at base addresses ``x_addr`` and
    ``out_addr``, and that each output byte is written once."""
    *lead, h, w, c = x.shape
    src = np.ascontiguousarray(x).reshape(-1).view(np.uint8)
    row, run = w * c * x.itemsize, f * c * x.itemsize
    assert row % run == 0 and row % word == 0 and 0 < slice_ <= run
    assert slice_ == run or (cells == 1 and slice_ % word == 0
                             and run % word == 0)
    assert cells * slice_ % word == 0 and f * cells * slice_ <= 64 * 1024
    assert x_addr % word == 0 and out_addr % word == 0
    out_rows, wo = src.size // (row * f), row // run
    cells = min(cells, wo)
    chunks, slices = -(-wo // cells), -(-run // slice_)
    piece = word
    while slice_ % piece:
        piece //= 2
    out = np.zeros_like(src)
    hits = np.zeros(src.size, np.int64)
    for t in range(out_rows * chunks * slices):
        orow, k = divmod(t, chunks * slices)
        chunk, sl = divmod(k, slices)
        x0, r0 = chunk * cells, sl * slice_
        tslice = min(slice_, run - r0)
        seg = min(cells, wo - x0) * tslice
        t_in = orow * f * row + x0 * run + r0
        t_out = orow * f * row + x0 * f * run + r0
        assert seg % word == 0
        stage = np.empty(f * seg, np.uint8)  # load_tile
        for dy in range(f):
            a = t_in + dy * row
            assert (x_addr + a) % word == 0
            stage[dy * seg:(dy + 1) * seg] = src[a:a + seg]
        o = np.arange(0, f * seg, word)  # store_tile: one word a thread
        q, r = np.divmod(o, tslice)
        cell, dy = np.divmod(q, f)
        dst = t_out + (cell * f + dy) * run + r
        assert np.all((out_addr + dst) % word == 0)
        words = np.empty((o.size, word), np.uint8)
        for j in range(word // piece):
            at = dy * seg + cell * tslice + r
            words[:, j * piece:(j + 1) * piece] = \
                stage[at[:, None] + np.arange(piece)]
            r = r + piece
            wrap = r == tslice
            r[wrap] = 0
            dy[wrap] += 1
            wrap = dy == f
            dy[wrap] = 0
            cell[wrap] += 1
        idx = dst[:, None] + np.arange(word)
        out[idx] = words
        np.add.at(hits, idx.ravel(), 1)
    assert (hits == 1).all()
    return out.view(x.dtype).reshape(*lead, h // f, w // f, f * f * c)


def _bytes(shape, dtype, seed):
    """Random bytes of every value (so no two runs look alike), as dtype."""
    n = int(np.prod(shape)) * np.dtype(dtype).itemsize
    raw = np.random.default_rng(seed).integers(0, 256, n, dtype=np.uint8)
    return raw.view(dtype).reshape(shape)


def _check_k2(x, f, plan, **addr):
    want = pixel_shuffle.space_to_depth_ref(torch.from_numpy(x), f).numpy()
    got = _emulate_k2(x, f, *plan, **addr)
    assert got.shape == want.shape
    assert np.array_equal(got.view(np.uint8), want.view(np.uint8)), plan


@pytest.mark.parametrize("dtype", [np.uint8, np.int16, np.float32])
@pytest.mark.parametrize("f,c", [(2, 3), (4, 3), (3, 2), (2, 4)])
def test_k2_index_math_every_word_size(dtype, f, c):
    """At every global word the addresses allow (16 bytes down to 1) and at
    three stage sizes (the whole band, a few cells with a ragged last chunk,
    and runs cut in slices), the kernel's mapping gives the plain version."""
    x = _bytes((1, 2, 12, 48, c), dtype, 4)
    row, run = 48 * c * x.itemsize, f * c * x.itemsize
    assert pixel_shuffle.pack_plan(row, run, f, 256, 512)[0] == 16
    for addr in (0, 8, 4, 2, 1):  # the widest word dividing addr: 16 .. 1
        if addr % x.itemsize:
            continue
        for stage in (pixel_shuffle.STAGE_BYTES, 5 * f * run, f * run // 2):
            plan = pixel_shuffle.pack_plan(row, run, f, addr, 0,
                                           stage_bytes=stage)
            assert plan[0] <= (addr or 16)
            _check_k2(x, f, plan, x_addr=addr)


def test_k2_word_follows_alignment():
    plan = pixel_shuffle.pack_plan
    # the main path, bf16 (1, 8, 720, 1280, 3), f=2: a band per tile
    assert plan(7680, 12, 2, 256, 512) == (16, 640, 12)
    assert plan(7680, 12, 2, 258, 512) == (2, 640, 12)  # a view at +1 value
    assert plan(3840, 6, 2, 256, 512) == (16, 640, 6)  # the same clip in u8
    # (6, 9, 2) fp32, f=3: a 72-byte row, so 8-byte words
    assert plan(72, 24, 3, 256, 512) == (8, 3, 24)
    # (.., 64, 8192, 3) fp32, f=2: a 196,608-byte band in 13 chunks
    assert plan(98304, 24, 2, 256, 512) == (16, 340, 24)
    # runs of 65,536 bytes (fp32, C=4096, f=4): a cell per tile, in slices
    assert plan(8 * 16384, 65536, 4, 256, 512) == (16, 1, 4096)
    assert plan(8 * 16384, 65536, 4, 256, 516) == (4, 1, 4096)


@pytest.mark.parametrize("dtype,f,cells,slice_", [
    (np.uint8, 2, 640, 6),       # the whole band, 16-byte words
    (np.uint8, 2, 8, 6),         # 80 chunks of the fewest whole-word cells
    (np.uint8, 2, 168, 6),       # 4 chunks, the last one ragged (136)
    (np.int16, 3, 6, 18),        # 4 chunks of runs of 18 bytes: 4-byte words
    (np.int16, 3, 5, 18),        # chunks of odd cells: 2-byte words
    (np.float32, 2, 1, 8),       # runs of 24 bytes in 3 slices
    (np.float32, 4, 1, 16),      # runs of 48 bytes, ragged last slice
])
def test_k2_tiles_split_bands(dtype, f, cells, slice_):
    """A band split across chunks of cells, and runs split across slices,
    still cover the output once and give the plain version."""
    c = 3
    x = _bytes((1, 1, 2 * f, 1280 if dtype == np.uint8 else 60, c), dtype, 5)
    row = x.shape[-2] * c * x.itemsize
    word = next(wd for wd in (16, 8, 4, 2, 1)
                if row % wd == 0 and cells * slice_ % wd == 0
                and (slice_ == f * c * x.itemsize or slice_ % wd == 0))
    _check_k2(x, f, (word, cells, slice_))


def test_k2_wide_band_plan():
    """The chip check's wide frame, (.., 8192, 3) fp32 at f=2, one row pair:
    the default plan cuts each 196,608-byte band into 13 chunks."""
    x = _bytes((1, 1, 2, 8192, 3), np.float32, 6)
    plan = pixel_shuffle.pack_plan(8192 * 12, 24, 2, 256, 512)
    _check_k2(x, 2, plan)


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
