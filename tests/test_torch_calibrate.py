"""The port's calibration of static int8 activation scales on the CPU
(``bin_tpu_torch/calibrate.py``, the models' ``"calib"`` mode) against
``bin_tpu``'s ``quant_stats`` pass (``tools/calibrate_int8.py``, run as
``tests/test_quant.py`` runs it): the same keys, the values within 1e-6
relative in fp32 (the two frameworks sum the convs in other orders, so an
abs-max can move by a few fp32 ulps; measured 3.6e-7); the sidecar read by
both packages and by the serving mode's provenance check, which the
evaluator makes of a sidecar named by ``--set``; the CLI on the CPU, and
its refusal without a card.  Tiny widths (base 8, one mid
ResBlock, ConvLSTM F=16), 32x32 clips.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bin_tpu.config import get_config as jax_get_config
from bin_tpu.ops import quant as jq
from bin_tpu.registry import build_model as jax_build_model
from bin_tpu_torch import benchmark, build_model, calibrate
from bin_tpu_torch.config import get_config
from bin_tpu_torch.evaluation import evaluator
from bin_tpu_torch.models.layers import Int8Conv, QATConv
from bin_tpu_torch.ops import quant
from bin_tpu_torch.weights import export_weights
from torch_params import one_torch_thread  # noqa: F401 (fixture)
from torch_params import random_flax_params

TINY = ["model.base_features=8", "model.num_res_blocks=1",
        "model.convlstm_features=16"]


def _jax_scales(params, clip, sets) -> dict:
    """bin_tpu's calibration: the quant_stats of every window, carries
    warmed, max-reduced; {key: float32 scale} as the tool writes them."""
    jcfg = jax_get_config("config3_prf", [*TINY, *sets,
                                          "model.conv_int8_calibrate=true"])
    model = jax_build_model(jcfg)
    k = jcfg.model.window_size
    b, _, h, w, _ = clip.shape
    states = model.initial_state(b, h, w)
    merged = None
    for s in range(clip.shape[1] - k + 1):
        (_, states), upd = model.module.apply(
            {"params": params}, jnp.asarray(clip[:, s:s + k]), states,
            producer_clamp=True, mutable=["quant_stats"])
        merged = upd["quant_stats"] if merged is None else jax.tree.map(
            jnp.maximum, merged, upd["quant_stats"])
    out = {}
    for path, amax in jax.tree_util.tree_flatten_with_path(merged)[0]:
        parts = [p.key for p in path]
        key = "/".join(parts[:-1] + [parts[-1][:-len("_amax")]])
        out[key] = np.float32(max(float(amax), 1e-8) / 127.0)
    return out


@pytest.fixture(scope="module")
def case():
    cfg = get_config("config3_prf", TINY)
    params = random_flax_params(build_model(cfg.model, "cpu").module, seed=7)
    clips = [np.random.default_rng(s).uniform(0, 1, (1, 7, 32, 32, 3))
             .astype(np.float32) for s in (3, 4)]
    return cfg, params, clips


def test_calibration_matches_bin_tpu_quant_stats(case):
    cfg, params, clips = case
    model = calibrate.calibration_model(cfg, params, "cpu", "float32")
    ours = calibrate.calibrate(model, clips)
    theirs = _jax_scales(params, np.concatenate(clips[:1]),
                         ["model.dtype=float32"])
    # bin_tpu ran the first clip only: the port's first clip alone
    first = calibrate.calibrate(model, clips[:1])
    assert sorted(first) == sorted(theirs)
    # every backbone 3x3 conv of _conv3x3_maybe_quant (13 a level at one
    # mid ResBlock) and two gate inputs a ConvLSTM, 3 levels
    assert len(first) == 3 * 13 + 3 * 2
    assert {"level_1/mid_0/Conv_1", "lstm_1/gates_x", "lstm_3/gates_h",
            "level_3/head/Conv_0"} <= set(first)
    worst = max(abs(first[k] / theirs[k] - 1) for k in theirs)
    assert worst <= 1e-6, worst
    # the maxima restart from 0 per call and reduce over clips
    assert all(ours[k] >= first[k] for k in ours)
    assert any(ours[k] > first[k] for k in ours)
    again = calibrate.calibrate(model, clips[:1])
    assert all(again[k] == first[k] for k in first)
    assert all(t.device.type == "cpu" and t.dtype == torch.float32
               for t in model.module.quant_stats.values())


def test_the_margin_scales_the_scales(case):
    cfg, params, clips = case
    model = calibrate.calibration_model(cfg, params, "cpu", "float32")
    one = calibrate.calibrate(model, clips[:1])
    wide = calibrate.calibrate(model, clips[:1], margin=1.25)
    amax = {k: float(t) for k, t in model.module.quant_stats.items()}
    for k in one:
        assert wide[k] == np.float32(max(amax[k], 1e-8) * 1.25 / 127.0)
        assert one[k] == np.float32(max(amax[k], 1e-8) / 127.0)


def test_sidecar_loads_in_both_packages_and_serves(case, tmp_path):
    cfg, params, clips = case
    model = calibrate.calibration_model(cfg, params, "cpu")
    scales = calibrate.calibrate(model, clips[:1])
    path = str(tmp_path / "best.scales.npz")
    calibrate.write_scales(path, scales, str(tmp_path / "best.npz"))
    for load, tag in ((jq.load_act_scales, jq.scales_calibrated_for),
                      (quant.load_act_scales, quant.scales_calibrated_for)):
        got = load(path)
        assert sorted(got) == sorted(scales)
        assert all(got[k] == float(scales[k]) for k in scales)
        assert tag(path) == "best.npz"
    # the serving mode's provenance check: the new sidecar for its weights
    # only, and never the release's sidecar for other weights
    assert benchmark.sidecar_mismatch(str(tmp_path / "best.npz"), path) is None
    assert "calibrated for best.npz" in benchmark.sidecar_mismatch(
        benchmark.WEIGHTS, path)
    assert not any("conv_int8_static" in s for s in
                   benchmark.serving_overrides(str(tmp_path / "best.npz")))
    # and drives the static int8 mode, every scale from the file
    serving = get_config("config3_prf", [
        *TINY, "model.conv_int8=true", "model.conv_int8_lstm=true",
        f"model.conv_int8_static={path}"])
    m = build_model(serving.model, "cpu").load_params(params)
    convs = [(n, c) for n, c in m.module.named_modules()
             if isinstance(c, Int8Conv)]
    assert convs and all(c.act_scale == float(scales[n.replace(".", "/")])
                         for n, c in convs)
    video, _ = m.infer_clip(torch.from_numpy(clips[0][:, :6]))
    assert torch.isfinite(video).all()


def test_the_evaluator_serves_a_qat_card_with_its_own_sidecar(
        case, tmp_path, capsys, monkeypatch):
    """A QAT fine-tune's ``best.npz``, whose card keeps ``conv_int8_qat``,
    scored by the evaluator's ``--serving`` with the sidecar calibrated for
    it, named by ``--set`` as a user names it: the sidecar passes the
    provenance check, and the model runs the int8 convs with its scales and
    no QAT conv.  The release's sidecar named for the same weights is
    refused before anything is built."""
    cfg, params, clips = case
    best = str(tmp_path / "best.npz")
    export_weights(best, params, dataclasses.replace(
        cfg.model, conv_int8_qat=True, conv_int8_min_cin=16),
        {"preset": "config3_prf"})
    scales = calibrate.calibrate(
        calibrate.calibration_model(cfg, params, "cpu"), clips[:1])
    path = str(tmp_path / "best.scales.npz")
    calibrate.write_scales(path, scales, best)
    built = []
    score = evaluator.evaluate
    monkeypatch.setattr(evaluator, "evaluate", lambda model, *a, **k: (
        built.append(model), score(model, *a, **k))[1])
    argv = ["--weights", best, "--device", "cpu", "--num-clips", "1",
            "--serving", "--set", "data.eval_size=32,32",
            "--set", "data.eval_num_keys=6",
            "--set", "model.conv_int8_min_cin=16"]
    evaluator.main([*argv, "--set", f"model.conv_int8_static={path}"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert np.isfinite(line["psnr_overall"])
    (model,) = built
    assert model.cfg.conv_int8 and not model.cfg.conv_int8_qat
    assert not any(isinstance(m, QATConv) for m in model.module.modules())
    convs = [(n, c) for n, c in model.module.named_modules()
             if isinstance(c, Int8Conv)]
    assert convs and all(c.act_scale == float(scales[n.replace(".", "/")])
                         for n, c in convs)
    release = os.path.join(benchmark.REPO,
                           benchmark.SERVING_OVERRIDES["model.conv_int8_static"])
    with pytest.raises(ValueError, match="serving best.npz"):
        evaluator.main([*argv, "--set", f"model.conv_int8_static={release}"])
    assert len(built) == 1


def test_calibrate_entry_on_the_cpu(case, tmp_path, capsys):
    cfg, params, _ = case
    weights = str(tmp_path / "w.npz")
    export_weights(weights, params, cfg.model, {"preset": "config3_prf"})
    out = str(tmp_path / "w.scales.npz")
    record = calibrate.main([
        "--checkpoint", weights, "--out", out, "--device", "cpu",
        "--size", "32", "48", "--keys", "6", "--clips", "2", "--seed", "5",
        *sum((["--set", s] for s in TINY), [])])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == record and line["keys"] == 45
    assert line["size"] == [32, 48] and line["device"] == "cpu"
    with np.load(out) as data:
        assert str(data["__calibrated_for__"]) == "w.npz"
        written = {k: data[k] for k in data.files if not k.startswith("__")}
    # the same scales from the library calls, in bf16 as the tool runs
    from bin_tpu_torch.data.pipeline import SyntheticSource
    source = SyntheticSource(2, 6, 32, 48, seed=5,
                             style=cfg.data.synthetic_style)
    model = calibrate.calibration_model(cfg, params, "cpu")
    want = calibrate.calibrate(model, (source[i]["blurry"][None]
                                       for i in range(2)))
    assert sorted(written) == sorted(want)
    assert all(written[k] == want[k] and written[k].dtype == np.float32
               for k in want)


def test_calibrate_entry_raises_without_a_card(case, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg, params, _ = case
    weights = str(tmp_path / "w.npz")
    export_weights(weights, params, cfg.model, {})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calibrate.main(["--checkpoint", weights, "--out",
                        str(tmp_path / "s.npz"),
                        *sum((["--set", s] for s in TINY), [])])
    assert not (tmp_path / "s.npz").exists()
