"""The port's streaming session (``bin_tpu_torch/evaluation/streaming.py``)
on the CPU: the checks of ``tests/test_streaming.py`` on a small model at
32x32, its emission plan and its emissions against ``bin_tpu``'s
``StreamingSession`` on the same weights and keys, and its emissions
against ``infer_clip`` of the same keys, bit for bit.

Tolerance 2e-5 against ``bin_tpu`` in fp32: the two frameworks sum the
convolutions in another order, ~1e-6 per conv, through the pyramid and the
recurrence.  Within the port every comparison is exact: the session runs
the same module on the same windows as ``infer_clip``.
"""

import threading
import time

import numpy as np
import pytest
import torch

from bin_tpu.config import ModelConfig as JaxModelConfig
from bin_tpu.evaluation.streaming import StreamingSession as JaxSession
from bin_tpu.evaluation.streaming import _emit_plan as jax_emit_plan
from bin_tpu.registry import build_model as jax_build_model
from bin_tpu_torch import ModelConfig, build_model
from bin_tpu_torch.evaluation.streaming import StreamingSession, _emit_plan
from bin_tpu_torch.models import recurrent
from torch_params import one_torch_thread  # noqa: F401 (fixture)
from torch_params import random_flax_params

SMALL = dict(name="prf", base_features=8, channel_mult=(1, 2, 4),
             num_res_blocks=1, convlstm_features=16, stem_factor=1)
H = W = 32


def _model(**kw):
    cfg = ModelConfig(**dict(SMALL, **kw))
    model = build_model(cfg, device="cpu")
    params = random_flax_params(model.module)
    return model.load_params(params), params


@pytest.fixture(scope="module")
def small():
    return _model()


def _clip(b, k, seed=0):
    return (np.random.default_rng(seed)
            .uniform(0, 1, (b, k, H, W, 3)).astype(np.float32))


def _keys_u8(b, k, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (b, k, H, W, 3),
                                                dtype=np.uint8)


def _run(sess, clip):
    """Every (time, frame) of ``clip`` through ``sess``: pushes, polls, the
    flush and the final drain, frames as numpy."""
    got = []
    for i in range(clip.shape[1]):
        got += sess.push(clip[:, i])
        got += sess.poll()
    got += sess.flush()
    got += sess.drain()
    return [(t, f.numpy() if torch.is_tensor(f) else f) for t, f in got]


def test_streaming_contiguous_coverage(small):
    model, _ = small
    sess = StreamingSession(model, batch=1, height=H, width=W)
    clip = _clip(1, 8)
    emitted = []
    for i in range(8):
        for t, frame in sess.push(clip[:, i]):
            emitted.append(t)
            assert frame.shape == (1, H, W, 3)
            assert frame.dtype == torch.float32
    # keys 0..7 -> windows at 0..4 -> contiguous steady coverage of 1..11
    assert emitted == list(range(1, 12))
    emitted += [t for t, _ in sess.flush()]
    assert emitted == list(range(1, 14))
    assert sess.flush() == []  # idempotent


def test_streaming_reset_reproduces(small):
    model, _ = small
    sess = StreamingSession(model, batch=1, height=H, width=W)
    clip = _clip(1, 5, seed=1)
    out1 = [f for i in range(5) for _, f in sess.push(clip[:, i])]
    sess.reset()
    out2 = [f for i in range(5) for _, f in sess.push(clip[:, i])]
    assert len(out1) == len(out2) == 5
    for a, b in zip(out1, out2):
        assert torch.equal(a, b)


def test_streaming_state_matches_clip_scan(small):
    """After streaming a clip, the ConvLSTM carries equal the clip scan's
    final states: the streaming path is the scan, step by step."""
    model, _ = small
    clip = torch.from_numpy(_clip(1, 6, seed=2))
    with torch.inference_mode():
        _, final = recurrent.scan_windows(
            model.module, clip, model.initial_state(1, H, W),
            model.cfg.window_size, model.cfg.stem_factor, model.dtype)
    sess = StreamingSession(model, batch=1, height=H, width=W)
    for i in range(6):
        sess.push(clip[:, i])
    assert len(sess.states) == len(final) == 3
    for (h_s, c_s), (h_f, c_f) in zip(sess.states, final):
        assert torch.equal(h_s, h_f) and torch.equal(c_s, c_f)


def test_streaming_interp_only_model():
    model, _ = _model(name="backbone")
    sess = StreamingSession(model, batch=1, height=H, width=W)
    clip = _clip(1, 6)
    times = [t for i in range(6) for t, _ in sess.push(clip[:, i])]
    times += [t for t, _ in sess.flush()]
    assert times == [1, 3, 5, 7, 9]  # odd (midpoint) times only


def test_drain_equals_direct_materialization(small):
    """Batched drain() (emissions kept on the device, one stacked copy)
    returns exactly the frames push()/flush() return directly."""
    model, _ = small
    clip = _clip(1, 8, seed=3)
    s1 = StreamingSession(model, batch=1, height=H, width=W)
    direct = dict(_run(s1, clip))
    s2 = StreamingSession(model, batch=1, height=H, width=W,
                          buffer_drain=True)
    for i in range(8):
        assert s2.push(clip[:, i]) == []
    assert s2.flush() == []
    drained = dict(s2.drain())
    assert sorted(drained) == sorted(direct) == list(range(1, 14))
    for t in direct:
        np.testing.assert_array_equal(direct[t], drained[t])
    assert s2.drain() == []  # buffer cleared
    assert s1.drain() == []  # without buffer_drain nothing is retained


@pytest.mark.parametrize("stem", [1, 2])
def test_push_uint8_matches_float(stem):
    """A u8 push (packed, then /255 on the device) emits the same frames as
    a float push of ``u8 / 255``, bit for bit."""
    model, _ = _model(stem_factor=stem)
    frames_u8 = _keys_u8(1, 6)
    frames_f32 = torch.from_numpy(frames_u8).float() / 255.0
    outs = {}
    for name, clip in (("u8", frames_u8), ("f32", frames_f32)):
        sess = StreamingSession(model, batch=1, height=H, width=W)
        outs[name] = dict(_run(sess, clip))
    assert sorted(outs["u8"]) == sorted(outs["f32"]) == list(range(1, 10))
    for t in outs["u8"]:
        np.testing.assert_array_equal(outs["u8"][t], outs["f32"][t])


def test_drain_emit_u8(small):
    """emit_u8 drains device-quantized uint8 frames equal to the fp32 path
    quantized as round(clip(x, 0, 1) * 255)."""
    model, _ = small
    clip = _clip(1, 6)
    outs = {}
    for u8 in (False, True):
        sess = StreamingSession(model, batch=1, height=H, width=W,
                                buffer_drain=True, emit_u8=u8)
        outs[u8] = dict(_run(sess, clip))
    assert outs[True].keys() == outs[False].keys()
    for t, f_u8 in outs[True].items():
        assert f_u8.dtype == np.uint8 and f_u8.shape == (1, H, W, 3)
        ref = torch.round(torch.from_numpy(outs[False][t]).clamp(0, 1)
                          * 255).to(torch.uint8).numpy()
        np.testing.assert_array_equal(f_u8, ref)


def _fetchers():
    return sum(t.name == "bin-tpu-torch-stream-fetch"
               for t in threading.enumerate())


@pytest.mark.parametrize("u8", [False, True])
def test_async_drain_equals_buffered(small, u8):
    """async_drain (finalize in the step, a background fetch thread) delivers
    exactly the frames the buffered drain delivers: poll() over the stream
    plus the final drain() cover every emission once; reset() clears what
    is in flight; close() stops the thread."""
    model, _ = small
    clip = _clip(2, 8, seed=11)
    s_buf = StreamingSession(model, batch=2, height=H, width=W,
                             buffer_drain=True, emit_u8=u8)
    want = dict(_run(s_buf, clip))

    baseline = _fetchers()
    s_async = StreamingSession(model, batch=2, height=H, width=W,
                               emit_u8=u8, async_drain=True)
    assert _fetchers() == baseline + 1
    got = {}
    for i in range(8):
        assert s_async.push(clip[:, i]) == []
        for t, f in s_async.poll():
            assert t not in got
            got[t] = f
    s_async.flush()
    for t, f in s_async.drain():
        assert t not in got
        got[t] = f
    assert sorted(got) == sorted(want) == list(range(1, 14))
    for t in want:
        assert got[t].dtype == want[t].dtype
        np.testing.assert_array_equal(got[t], want[t])

    s_async.push(clip[:, 0])
    s_async.reset()
    assert s_async.poll() == [] and s_async.drain() == []
    s_async.close()
    for _ in range(100):
        if _fetchers() == baseline:
            break
        time.sleep(0.05)
    assert _fetchers() == baseline, "fetch thread still alive after close"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", [{}, {"buffer_drain": True, "emit_u8": True},
                                  {"async_drain": True, "emit_u8": True}])
def test_emissions_equal_infer_clip(dtype, mode):
    """What the card's smoke checks at 720p: u8 keys streamed, each emission
    equal, bit for bit, to ``infer_clip`` of the keys fed as ``u8 / 255`` in
    fp32, quantized as the session's u8 finalize does."""
    model, _ = _model(stem_factor=2, dtype=dtype)
    keys = _keys_u8(1, 8, seed=5)
    video, times = model.infer_clip(torch.from_numpy(keys).float() / 255.0)
    sess = StreamingSession(model, batch=1, height=H, width=W, **mode)
    got = _run(sess, keys)
    sess.close()
    assert [t for t, _ in got] == list(times) == list(range(1, 14))
    for t, frame in got:
        want = video[:, t - 1]
        if frame.dtype == np.uint8:
            want = torch.round(want.clamp(0, 1) * 255).to(torch.uint8)
        np.testing.assert_array_equal(frame, want.numpy())


@pytest.mark.parametrize("window,levels", [(4, 3), (4, 1), (5, 2), (5, 4),
                                           (6, 3), (3, 2)])
def test_emit_plan_matches_bin_tpu(window, levels):
    num_levels, cycle = (levels - 1, True) if levels > 1 else (1, False)
    name = "prf" if levels > 1 else "backbone"
    kw = dict(name=name, window_size=window, num_levels=num_levels,
              cycle_level=cycle)
    jmodel = jax_build_model(JaxModelConfig(**kw))
    cfg = ModelConfig(**kw)
    assert jmodel.num_levels_total == levels
    for first in (True, False):
        assert _emit_plan(cfg, first) == jax_emit_plan(jmodel, first)


@pytest.mark.parametrize("stem,u8", [(1, False), (2, True)])
def test_emissions_match_bin_tpu_session(stem, u8):
    """The port's session against bin_tpu's on the same weights and keys, in
    fp32, interactive mode: the same times, frames within 2e-5."""
    kw = dict(SMALL, stem_factor=stem)
    model, params = _model(stem_factor=stem)
    jmodel = jax_build_model(JaxModelConfig(**kw))
    keys = (_keys_u8(1, 7, seed=9) if u8 else _clip(1, 7, seed=9))
    theirs = JaxSession(jmodel, params, batch=1, height=H, width=W)
    ours = StreamingSession(model, batch=1, height=H, width=W)
    want = [(t, np.asarray(f)) for t, f in _run(theirs, keys)]
    got = _run(ours, keys)
    assert [t for t, _ in got] == [t for t, _ in want] == list(range(1, 12))
    for (_, a), (_, b) in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=0, atol=2e-5)
    # and the carries after the stream
    for (h_s, c_s), (h_j, c_j) in zip(ours.states, theirs.states):
        np.testing.assert_allclose(h_s.numpy(), np.asarray(h_j), atol=2e-5)
        np.testing.assert_allclose(c_s.numpy(), np.asarray(c_j), atol=2e-5)


def test_push_rejects_a_wrong_shape(small):
    model, _ = small
    sess = StreamingSession(model, batch=1, height=H, width=W)
    with pytest.raises(ValueError, match="expected"):
        sess.push(np.zeros((1, H, W + 4, 3), np.float32))
