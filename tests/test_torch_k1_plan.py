"""K1 and K1b's plan (``ops/lstm_gates.k1_plan``) and their map from a
thread's items to (row, run of features), on the CPU.

The kernels (``bin_tpu_torch/csrc/lstm_gates.cu``) run only on a card,
where ``chip_smoke.py`` holds them against their plain versions.  Here
numpy emulates the kernels' ``Walk`` (the grid-stride loop over items) and
the addresses each item reads and writes, at every V and at the grid sizes
a plan gives, and checks that every element is covered exactly once, at
the access widths the plan promises, with the plain version's values.
"""

import contextlib

import numpy as np
import pytest
import torch

from bin_tpu_torch.config import get_config
from bin_tpu_torch.ops import lstm_gates

BF16, FP32 = torch.bfloat16, torch.float32
SMS = 132  # the H100's SMs: the kernels' grid is at most SMs x resident


@pytest.mark.parametrize("dtype", [BF16, FP32])
@pytest.mark.parametrize("preset", ["config3_prf", "config5_v5e_streaming"])
def test_plan_takes_the_wide_vec_when_aligned(preset, dtype):
    """V = 4 at the clips' rows (16-byte runs of every fp32 tensor), and
    narrower where the rows are few (the train steps), every pointer
    16-byte aligned."""
    feat = get_config(preset).model.convlstm_features
    # rows of the 720p clip's and config5's clip's gates, the train step's
    # (4 x 16 x 16) and config5's step's (8 x 8 x 8)
    for rows, vec in ((14_400, 4), (3_600, 4), (1_024, 2), (512, 1)):
        plan = lstm_gates.k1_plan(rows, feat, dtype, (0, 4096), (256, 512))
        assert plan["vec"] == vec
        assert plan["items"] == rows * feat // vec >= min(
            lstm_gates.MIN_ITEMS, rows * feat)
        assert 128 <= plan["threads"] <= 256 and plan["threads"] % 32 == 0
        assert plan["blocks"] == -(-plan["items"] // plan["threads"])
    assert lstm_gates.k1_plan(14_400, feat, dtype)["vec"] == 4


@pytest.mark.parametrize("feat,dtype,gate_ptrs,state_ptrs,vec", [
    (300, BF16, (0,), (0,), 4),       # 300 = 4 x 75
    (300, FP32, (0,), (0,), 4),
    (150, BF16, (0,), (0,), 2),
    (150, FP32, (0,), (0,), 2),
    (75, BF16, (0,), (0,), 1),
    (75, FP32, (0,), (0,), 1),
    (1, BF16, (0,), (0,), 1),
    (1, FP32, (0,), (0,), 1),
    (256, BF16, (2,), (0,), 1),       # gates one bf16 value in
    (256, FP32, (4,), (0,), 1),       # gates one fp32 value in
    (256, BF16, (0, 2), (0,), 1),     # K1b's dgates one value in
    (256, BF16, (4,), (0,), 2),       # 4 bytes in: 2 bf16 a run
    (256, BF16, (8,), (0,), 4),       # 8 bytes in: 4 bf16 a run
    (256, BF16, (0,), (0, 4), 1),     # a state tensor one value in
    (256, BF16, (0,), (8,), 2),       # 8 bytes in: float2s
    (256, FP32, (0,), (8,), 2),
    (256, FP32, (8,), (0,), 2),
    (256, BF16, (0,), (4096 + 16,), 4),  # 16 bytes in stays aligned
])
def test_plan_narrows_vec(feat, dtype, gate_ptrs, state_ptrs, vec):
    rows = 4096  # enough items at every V
    plan = lstm_gates.k1_plan(rows, feat, dtype, gate_ptrs, state_ptrs)
    assert plan["vec"] == vec
    assert plan["items"] == rows * feat // vec


@pytest.mark.parametrize("dtype", [BF16, FP32])
def test_plan_spreads_few_items_over_more_threads(dtype):
    """Below MIN_ITEMS items at V = 4, V halves while it can."""
    for rows, vec in ((1, 1), (3, 1), (512, 1), (1023, 1), (1024, 2),
                      (2047, 2), (2048, 4)):
        assert lstm_gates.k1_plan(rows, 256, dtype)["vec"] == vec, rows


def _magic(runs):
    """``grid_for``'s divisor by ``runs``: (magic, shift) with n // runs ==
    (umulhi(n, magic) + n) >> shift for n < 2^31."""
    shift = 0
    while (1 << shift) < runs:
        shift += 1
    return ((1 << 32) * ((1 << shift) - runs)) // runs + 1, shift


def _divide(n, runs):
    """``Walk``'s division of the items ``n`` (uint64, < 2^31) by ``runs``,
    in 32-bit unsigned arithmetic as the kernel does it."""
    magic, shift = _magic(runs)
    hi = (n * np.uint64(magic)) >> np.uint64(32)
    return ((hi + n) & np.uint64(0xFFFFFFFF)) >> np.uint64(shift)


def test_magic_division_is_exact():
    rng = np.random.default_rng(0)
    n = np.concatenate([np.arange(1 << 16, dtype=np.uint64),
                        rng.integers(0, 1 << 31, 1 << 16, dtype=np.uint64),
                        np.array([(1 << 31) - 1], np.uint64)])
    for runs in [*range(1, 1025), 1200, 4096, 65_535, 1 << 20]:
        assert _magic(runs)[0] < 1 << 32
        assert np.array_equal(_divide(n, runs), n // np.uint64(runs)), runs


def _walk(rows, feat, vec, threads, blocks):
    """``Walk`` of csrc/lstm_gates.cu for every thread at once: each
    thread's (row, run) items in the order it takes them, as two flat
    arrays."""
    runs = feat // vec
    stride = threads * blocks
    item = np.arange(stride, dtype=np.uint64)
    row = _divide(item, runs).astype(np.int64)
    run = item.astype(np.int64) - row * runs
    drow, drun = divmod(stride, runs)
    rows_seen, runs_seen = [], []
    while True:
        live = row < rows
        if not live.any():
            break
        rows_seen.append(row[live])
        runs_seen.append(run[live])
        row = row + drow
        run = run + drun
        wrap = run >= runs
        run = np.where(wrap, run - runs, run)
        row = np.where(wrap, row + 1, row)
    return np.concatenate(rows_seen), np.concatenate(runs_seen)


def _grids(rows, feat, vec):
    """The blocks a plan at ``vec`` needs and the smaller grids the card's
    limit makes (one to eight waves of its SMs); odd and single-block grids
    too where the items are few enough to walk."""
    items = rows * feat // vec
    need = -(-items // lstm_gates.THREADS)
    small = (min(need, 7), 1) if items <= 1 << 16 else ()
    return sorted({need, *(min(need, SMS * r) for r in (1, 2, 4, 8)),
                   *small})


CASES = [(14_400, 256, BF16), (1024, 256, FP32), (1024, 256, BF16),
         (512, 256, BF16), (70, 48, BF16), (12, 300, FP32), (5, 75, BF16),
         (3, 1, FP32)]


@pytest.mark.parametrize("rows,feat,dtype", CASES)
def test_walk_covers_every_element_once(rows, feat, dtype):
    """At each V that divides F (all three where the elements are few
    enough to walk fast, the plan's otherwise) and each grid size."""
    size = torch.empty((), dtype=dtype).element_size()
    planned = lstm_gates.k1_plan(rows, feat, dtype)["vec"]
    for vec in (v for v in (4, 2, 1) if feat % v == 0 and (
            v == planned or rows * feat <= 1 << 18)):
        for blocks in _grids(rows, feat, vec):
            r, u = _walk(rows, feat, vec, lstm_gates.THREADS, blocks)
            assert r.size == rows * feat // vec
            first = r * feat + u * vec            # into c, h', c', dh, dc
            state = (first[:, None] + np.arange(vec)).ravel()
            assert np.array_equal(np.bincount(state, minlength=rows * feat),
                                  np.ones(rows * feat, np.int64))
            gate_first = r * 4 * feat + u * vec   # block i; + b * feat
            gate = (gate_first[:, None, None] + feat * np.arange(4)[:, None]
                    + np.arange(vec)).ravel()
            assert np.array_equal(
                np.bincount(gate, minlength=4 * rows * feat),
                np.ones(4 * rows * feat, np.int64))
            # each access starts at a multiple of its width
            assert not (gate_first * size % (vec * size)).any()
            assert not (first * 4 % (vec * 4)).any()


@pytest.mark.parametrize("rows,feat,dtype", CASES[3:])
def test_walk_reads_each_outputs_gates(rows, feat, dtype):
    """The emulated kernel at each V that divides F (each item's four gate
    runs and cell run gathered through the walk, the plain version on them,
    scattered back) equals the plain version on the whole tensor."""
    rng = np.random.default_rng(0)
    gates = torch.from_numpy(
        rng.normal(0, 3, (rows, 4 * feat)).astype(np.float32)).to(dtype)
    c = torch.from_numpy(rng.normal(0, 1, (rows, feat)).astype(np.float32))
    h_r, c_r = lstm_gates.lstm_gate_math_ref(gates, c)
    for vec in (v for v in (4, 2, 1) if feat % v == 0):
        r, u = _walk(rows, feat, vec, lstm_gates.THREADS,
                     min(_grids(rows, feat, vec)[-1], 7))
        first = r * feat + u * vec
        idx = torch.from_numpy((first[:, None] + np.arange(vec)).ravel())
        gidx = torch.from_numpy((r * 4 * feat + u * vec)[:, None, None]
                                + feat * np.arange(4)[None, :, None]
                                + np.arange(vec))  # (items, block, vec)
        g_items = gates.reshape(-1)[gidx].transpose(1, 2).reshape(-1, 4)
        h_i, c_i = lstm_gates.lstm_gate_math_ref(
            g_items, c.reshape(-1)[idx][:, None])
        h = torch.full((rows * feat,), float("nan"))
        cn = torch.full((rows * feat,), float("nan"))
        h[idx], cn[idx] = h_i[:, 0], c_i[:, 0]
        torch.testing.assert_close(h.view(rows, feat), h_r, rtol=0,
                                   atol=1e-6)
        torch.testing.assert_close(cn.view(rows, feat), c_r, rtol=0,
                                   atol=1e-6)


class _Lib:
    """Stands in for the kernel library: records each entry point's
    arguments and returns success."""

    def __init__(self):
        self.calls = []

    def btt_lstm_gates(self, *args):
        self.calls.append(("fwd", args))
        return 0

    def btt_lstm_gates_bwd(self, *args):
        self.calls.append(("bwd", args))
        return 0


@pytest.mark.parametrize("dtype", [BF16, FP32])
def test_wrappers_hand_the_plan_to_the_entry_points(monkeypatch, dtype):
    """On tensors that claim CUDA, the wrappers pass the plan's vec and
    threads in the entry points' order (``ops/native.py`` argtypes: after
    the forget bias, before the stream) and count one launch each."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    lib = _Lib()
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    monkeypatch.setattr(lstm_gates.native, "library", lambda: lib)
    monkeypatch.setattr(lstm_gates.native, "stream", lambda device: 0)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    gates = torch.empty(2, 3, 4, 4 * 300, device="meta", dtype=dtype)
    c, dh, dc = (torch.empty(2, 3, 4, 300, device="meta") for _ in range(3))
    before = (lstm_gates.launches, lstm_gates.bwd_launches)
    lstm_gates._k1(gates, c, 0.5)
    lstm_gates.fused_lstm_gates_bwd(gates, c, dh, dc, 0.5)
    assert (lstm_gates.launches, lstm_gates.bwd_launches) == (
        before[0] + 1, before[1] + 1)
    plan = lstm_gates.k1_plan(24, 300, dtype)
    (fwd, a), (bwd, b) = lib.calls
    assert fwd == "fwd" and len(a) == 11
    assert a[1] == int(dtype == BF16) and a[5:10] == (
        24, 300, 0.5, plan["vec"], plan["threads"])
    assert bwd == "bwd" and len(b) == 13
    assert b[7:12] == (24, 300, 0.5, plan["vec"], plan["threads"])
