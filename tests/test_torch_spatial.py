"""Height (spatial) sharding of the port (``bin_tpu_torch/parallel/
spatial.py``) on the CPU.

- The bands: every level of the backbone tiled by whole bands at the
  presets' eval heights and at the heights ``bin_tpu``'s tests shard,
  and the height ``bin_tpu`` refuses refused, naming the spatial axis.
- Each row-crossing module on its band, the neighbours' rows handed in,
  against the same module on the whole tensor: the float conv (stride 1
  and 2) within 1e-6, the int8 convs through K3's plain version (static
  and dynamic scale) bit for bit, and the upsample's phase conv.
- Four spawned gloo ranks (``tests/torch_spatial_worker.py``): a data 2 x
  spatial 2 ``StreamingSession(plan=)`` against the unsharded port and
  ``bin_tpu``'s session on a 2 x 2 mesh (rtol/atol 1e-5, ``bin_tpu``'s
  bound); the stem-4 window at height 720, whose bottleneck splits 23/22,
  against ``bin_tpu``'s window (2e-4/2e-5, ``tests/test_parallel_deep.py``)
  and the port's; ``evaluate_cli`` over the mesh against one process
  (rtol 1e-5, atol 1e-6); then two of them as a 1 x 2 mesh:
  ``FrameServer(spatial=2)`` with a follower rank, its u8 frames equal to
  a direct session's on its plan and within 1 level of the plain
  server's (the test says why), one ``train`` step, equal to the
  one-process step bit for bit (the spatial ranks compute replicas), and
  a sharded server whose follower fails: rank 0 answers 500, not a hang.
"""

import multiprocessing
import queue
import socket

import jax
import numpy as np
import pytest
import torch

from bin_tpu.config import ParallelConfig as JaxParallelConfig
from bin_tpu.config import get_config as jax_get_config
from bin_tpu.evaluation.streaming import StreamingSession as JaxSession
from bin_tpu.parallel.mesh import make_mesh as jax_make_mesh
from bin_tpu.registry import build_model as jax_build_model
from bin_tpu_torch import build_model
from bin_tpu_torch.config import PRESETS, get_config
from bin_tpu_torch.evaluation.evaluator import evaluate_cli
from bin_tpu_torch.evaluation.streaming import StreamingSession
from bin_tpu_torch.models.convlstm import Int8GateConv
from bin_tpu_torch.models.layers import Conv, Int8Conv, Upsample
from bin_tpu_torch.ops.quant import quantize_act_ref
from bin_tpu_torch.parallel import MeshPlan
from bin_tpu_torch.parallel.spatial import Halo, height_bands, packed_bands
from bin_tpu_torch.serving.server import FrameServer
from bin_tpu_torch.training import trainer
from torch_params import one_torch_thread  # noqa: F401 (fixture)
from torch_params import random_flax_params
import torch_spatial_worker as w

WORLD = 4
TIMEOUT_S = 240
LEVELS = 3  # channel_mult (1, 2, 4)


@pytest.fixture(autouse=True)
def grad_enabled():
    """Grad mode on: ``tests/torch_twin.py`` turns it off at import, and
    the suite's workers import every test module."""
    with torch.enable_grad():
        yield


# -- bands ------------------------------------------------------------------

_PRESET_CASES = sorted({(get_config(p).model.stem_factor,
                         get_config(p).data.eval_size[0], s)
                        for p in PRESETS for s in (2, 4)})


@pytest.mark.parametrize("stem,height,spatial", _PRESET_CASES + [
    (2, 720, 2), (2, 720, 4), (4, 720, 2), (2, 64, 4), (2, 48, 4),
    (2, 256, 2), (2, 32, 4), (2, 64, 2)])
def test_bands_tile_every_level(stem, height, spatial):
    bands = height_bands(stem, (1, 2, 4), height, spatial)
    assert bands[0][0] == 0 and len(bands) == spatial
    for (s0, n0), (s1, _) in zip(bands, bands[1:]):
        assert s0 + n0 == s1
    assert sum(n for _, n in bands) == height
    for start, rows in bands:
        assert start % stem == 0
        for level in range(LEVELS):  # whole rows at every level
            f = stem * 2 ** level
            assert start % f == 0 and rows % f == 0 and rows >= f
    sizes = [n // stem for _, n in bands]
    assert max(sizes) - min(sizes) <= 2 ** (LEVELS - 1)


@pytest.mark.parametrize("packed,spatial,want", [
    (360, 2, [180, 180]), (360, 4, [92, 92, 88, 88]), (180, 2, [92, 88]),
    (24, 4, [8, 8, 4, 4]), (16, 4, [4, 4, 4, 4])])
def test_bands_are_dealt_as_bin_tpus_examples(packed, spatial, want):
    assert [n for _, n in packed_bands(packed, spatial, 4)] == want


def test_heights_bin_tpu_refuses_are_refused():
    with pytest.raises(ValueError, match="spatial"):
        height_bands(2, (1, 2, 4), 36, 4)  # packed 18 over 4
    # what bin_tpu takes but whole blocks cannot cut: a height the model
    # cannot run, or fewer bottleneck rows than bands (ROADMAP.md)
    for height, spatial in ((20, 2), (16, 4)):
        with pytest.raises(ValueError, match="spatial=.*whole blocks"):
            height_bands(2, (1, 2, 4), height, spatial)
    model = build_model(get_config("config3_prf", w.TINY).model, "cpu")
    plan = MeshPlan(num_data=2, num_spatial=4, rank=1)
    with pytest.raises(ValueError, match="spatial"):
        StreamingSession(model, batch=2, height=36, width=32, plan=plan)
    with pytest.raises(ValueError, match="divide"):
        StreamingSession(model, batch=3, height=64, width=32, plan=plan)
    assert model.plan is None


# -- each row-crossing module on its band -----------------------------------

class Given(Halo):
    """The neighbours' rows handed in: the i-th exchange takes them from
    the i-th of ``wholes`` (the tensor of which the band is rows
    ``start:start + rows``), the i-th maximum over the bands from
    ``maxima``."""

    def __init__(self, wholes, start, maxima=()):
        self.wholes, self.start, self.maxima = list(wholes), start, list(
            maxima)

    def exchange(self, x, up, down):
        whole, s, r = self.wholes.pop(0), self.start, x.shape[1]
        above = whole[:, s - up:s] if s > 0 else None
        below = whole[:, s + r:s + r + down] if s + r < whole.shape[1] \
            else None
        return above, below

    def amax(self, t):
        return self.maxima.pop(0)


BANDS = [(0, 6), (6, 6), (12, 4)]  # even starts: the stride-2 conv's rule


def _banded(module, x, halos, *extra):
    """The module on each band of ``x`` (and of ``extra``), with the halo
    that ``halos(start)`` makes, its outputs joined."""
    outs = []
    for start, rows in BANDS:
        module.halo = halos(start)
        outs.append(module(x[:, start:start + rows],
                           *(e[:, start:start + rows] for e in extra)))
    module.halo = None
    return torch.cat(outs, dim=1)


def _x(seed, c=32):
    return torch.from_numpy(np.random.default_rng(seed).normal(
        0, 1, (2, 16, 8, c)).astype(np.float32))


@pytest.mark.parametrize("stride", [1, 2])
def test_float_conv_on_its_band(stride):
    torch.manual_seed(stride)
    conv, x = Conv(32, 16, 3, stride), _x(0)
    with torch.no_grad():
        want = conv(x)
        got = _banded(conv, x, lambda s: Given([x], s))
    assert got.shape == want.shape
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("static", [True, False])
def test_int8_conv_on_its_band(stride, static):
    torch.manual_seed(stride)
    conv, x = Int8Conv(32, 16, stride), _x(1)
    conv.act_scale = 0.02 if static else None
    conv.quantize()
    amax = x.abs().amax()
    scale = torch.tensor(0.02) if static else amax.clamp_min(1e-8) / 127
    with torch.no_grad():
        want = conv(x)
        got = _banded(conv, x, lambda s: Given(
            [quantize_act_ref(x, scale)], s, [amax]))
    assert torch.equal(got, want)


@pytest.mark.parametrize("static", [True, False])
def test_int8_gate_conv_on_its_band(static):
    torch.manual_seed(0)
    conv, x, h = Int8GateConv(32, 32, 64), _x(2), _x(3)
    conv.act_scales = (0.03, 0.02) if static else (None, None)
    conv.quantize()
    ax, ah = x.abs().amax(), h.abs().amax()
    sx, sh = ((torch.tensor(0.03), torch.tensor(0.02)) if static else
              (ax.clamp_min(1e-8) / 127, ah.clamp_min(1e-8) / 127))
    with torch.no_grad():
        want = conv(x, h)
        got = _banded(conv, x, lambda s: Given(
            [quantize_act_ref(x, sx), quantize_act_ref(h, sh)], s,
            [ax, ah]), h)
    assert torch.equal(got, want)


def test_upsample_on_its_band():
    torch.manual_seed(0)
    up, x = Upsample(32, 16), _x(4)
    up.prepare()
    with torch.no_grad():
        want = up(x)
        got = _banded(up, x, lambda s: Given([x], s))
    assert got.shape == want.shape == (2, 32, 16, 16)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)


# -- spawned ranks ----------------------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _params():
    """The three small models' parameters, from numpy seeds."""
    out = {}
    for name, cfg, seed in (
            ("stream", get_config("config3_prf", w.TINY).model, 1),
            ("window", get_config("config5_v5e_streaming",
                                  [*w.TINY, "model.dtype=float32"]).model, 2),
            ("server", w.server_config(), 3)):
        out[name] = random_flax_params(build_model(cfg, "cpu").module, seed)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The four ranks' results, and the references this process computes
    while they run: the unsharded port and ``bin_tpu``."""
    params = _params()
    workdir = str(tmp_path_factory.mktemp("spatial_train"))
    ctx = multiprocessing.get_context("spawn")
    out = ctx.Queue()
    ports = (_free_port(), _free_port())
    procs = [ctx.Process(target=w.run_rank,
                         args=(r, ports, workdir, params, out), daemon=True)
             for r in range(WORLD)]
    for p in procs:
        p.start()
    try:
        ref = _references(params, str(tmp_path_factory.mktemp("one_train")))
        results = {}
        for _ in range(WORLD):
            try:
                res = out.get(timeout=TIMEOUT_S)
            except queue.Empty:
                pytest.fail(f"a rank sent nothing in {TIMEOUT_S} s")
            assert "error" not in res, res.get("error")
            results[res["rank"]] = res
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
    return results, ref


def _references(params, workdir) -> dict:
    ref = {}
    model = build_model(get_config("config3_prf", w.TINY).model,
                        "cpu").load_params(params["stream"])
    ref["stream"] = w.run_stream(model, None)
    jax_cfg = jax_get_config("config3_prf", w.TINY)
    s = w.STREAM
    sess = JaxSession(jax_build_model(jax_cfg), params["stream"],
                      batch=s["batch"], height=s["height"],
                      width=s["width"], buffer_drain=True,
                      plan=jax_make_mesh(JaxParallelConfig(
                          data_axis_size=2, spatial_axis_size=2)))
    for key in w.stream_keys():
        sess.push(key)
    sess.flush()
    ref["jax_stream"] = sess.drain()

    c5 = [*w.TINY, "model.dtype=float32"]
    model = build_model(get_config("config5_v5e_streaming", c5).model,
                        "cpu").load_params(params["window"])
    clip = w.window_clip()
    with torch.inference_mode():
        outs, states = model.module(torch.from_numpy(clip),
                                    model.initial_state(2, 720, 256),
                                    producer_clamp=False)  # bin_tpu's
    ref["window"] = ([o.numpy() for o in outs],
                     [(h.numpy(), c.numpy()) for h, c in states])
    jax_model = jax_build_model(jax_get_config("config5_v5e_streaming", c5))
    outs, states = jax.jit(jax_model.apply_window)(
        params["window"], clip, jax_model.initial_state(2, 720, 256))
    ref["jax_window"] = ([np.asarray(o) for o in outs],
                         [(np.asarray(h), np.asarray(c)) for h, c in states])

    ref["eval"] = evaluate_cli(get_config("config3_prf", w.EVAL),
                               device="cpu", verbose=False)
    server = FrameServer(build_model(w.server_config(), "cpu").load_params(
        params["server"]))
    sid = server.create_stream(w.SERVER["height"], w.SERVER["width"])
    got = []
    for frame in w.server_frames():
        got += server.push(sid, frame)[0]
    ref["server"] = got + server.close(sid)
    _, state = trainer.train(get_config("config3_prf", w.TRAIN), workdir, 1,
                             device="cpu")
    ref["train"] = {k: v.detach().numpy().copy()
                    for k, v in state.named(state.params).items()}
    return ref


def test_ranks_form_a_data_by_spatial_mesh(runs):
    results, _ = runs
    assert [results[r]["plan"] for r in range(WORLD)] == [
        (2, 2, 0, 0), (2, 2, 0, 1), (2, 2, 1, 0), (2, 2, 1, 1)]
    exchanges, sent = results[0]["halo"]
    assert exchanges > 0 and sent > 0


def test_sharded_stream_equals_the_unsharded_and_bin_tpus(runs):
    results, ref = runs
    want = ref["stream"]
    for r in range(WORLD):
        got = results[r]["stream"]
        assert [t for t, _ in got] == [t for t, _ in want]
        for (_, a), (_, b) in zip(got, want):
            assert a.shape == (w.STREAM["batch"], w.STREAM["height"],
                               w.STREAM["width"], 3)
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
    assert [t for t, _ in ref["jax_stream"]] == [t for t, _ in want]
    for (_, a), (_, b) in zip(results[0]["stream"], ref["jax_stream"]):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)


def _joined(results, pick):
    """The ranks' bands joined: rows over the spatial index (axis 2 of a
    packed (B, P, h, w, C) output, axis 1 of a carry), streams over the
    data index."""
    rows = []
    for d in range(2):
        parts = [pick(results[2 * d + s]["window"]) for s in range(2)]
        rows.append(np.concatenate(parts, axis=parts[0].ndim - 3))
    return np.concatenate(rows, axis=0)


def test_stem4_720_window_with_an_uneven_bottleneck(runs):
    results, ref = runs
    assert [results[r]["window"]["band"] for r in range(2)] == [
        (0, 368), (368, 352)]  # packed 92/88, bottleneck 23/22
    assert results[1]["window"]["states"][0][0].shape[1] == 22
    for source, rtol, atol in ((ref["window"], 1e-6, 1e-6),
                               (ref["jax_window"], 2e-4, 2e-5)):
        outs, states = source
        for li, want in enumerate(outs):
            got = _joined(results, lambda r: r["outputs"][li])
            np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)
        for li, (h, c) in enumerate(states):
            for j, want in enumerate((h, c)):
                got = _joined(results, lambda r: r["states"][li][j])
                np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


def test_evaluate_cli_over_the_mesh_equals_one_process(runs):
    results, ref = runs
    for r in range(WORLD):
        got = results[r]["eval"]
        assert sorted(got) == sorted(ref["eval"])
        for k in got:
            np.testing.assert_allclose(got[k], ref["eval"][k], rtol=1e-5,
                                       atol=1e-6)


def test_sharded_server_frames_equal_the_plain_servers(runs):
    """The sharded server's u8 frames equal a direct session's on its plan,
    bit for bit (what rank 0 serves is what the ranks computed), and the
    plain server's within 1 level on at most 1 % of the bytes: on the CPU
    the plain versions' conv of a 2-row band at batch 1 (the cycle level's
    bottleneck) sums in another order than the 4-row frame's, 1 ulp, which
    flips a value sitting at a .5 boundary."""
    results, ref = runs
    got, want = results[0]["server"]["server"], ref["server"]
    assert results[1]["server"]["server"] is None  # the follower
    assert [t for t, _ in got] == [t for t, _ in want]
    assert len(got) == 2 * w.SERVER["keys"] - 3  # times 1 .. 2K - 3
    for r in range(2):
        direct = results[r]["server"]["direct"]
        assert [t for t, _ in direct] == [t for t, _ in got]
        for (_, a), (_, b) in zip(got, direct):
            np.testing.assert_array_equal(a, b)
    flips = 0
    for (_, a), (_, b) in zip(got, want):
        assert a.dtype == b.dtype == np.uint8
        d = np.abs(a.astype(np.int16) - b.astype(np.int16))
        assert d.max() <= 1
        flips += int(np.count_nonzero(d))
    assert flips <= 0.01 * len(got) * got[0][1].size


def test_train_step_over_spatial_replicas_equals_one_process(runs):
    results, ref = runs
    a, b = results[0]["train"], results[1]["train"]
    assert sorted(a) == sorted(ref["train"])
    for k in a:
        assert np.array_equal(a[k], b[k]), k
        assert np.array_equal(a[k], ref["train"][k]), k


def test_a_failing_follower_fails_rank_0s_calls(runs):
    """A follower whose push fails ends its loop and its process, so rank
    0's next collective with it fails: that push answers HTTP 500 within
    the client's 60 s, naming rank 0's error, and every later push 500
    without running; /healthz says "down"."""
    results, _ = runs
    assert "the follower's push failed" in results[1]["down"]["follower"]
    down = results[0]["down"]
    outcomes = down["outcomes"]
    first = next(i for i, o in enumerate(outcomes) if o != "ok")
    assert first < len(outcomes) - 1, down
    assert outcomes[first].startswith("push -> 500"), down
    assert "rank 0: " in outcomes[first], down
    for later in outcomes[first + 1:]:
        assert later.startswith("push -> 500"), down
        assert "the sharded server is down" in later, down
    assert down["health"] == "down"
    assert down["seconds"] < 60
