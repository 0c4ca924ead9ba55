"""The port's evaluation path on the CPU against ``bin_tpu``'s: the eval
clips (byte for byte), PSNR and SSIM, ``clip_metrics_fn`` and
``evaluate`` on a small random-weights model and on the release weights,
the protocol config and the evaluator's entry.

Tolerances: the clips are equal bytes (the same numpy code); the metrics
within 1e-5 on the same frames (fp32 sums in another order); the per-clip
scores of the two frameworks' models, whose frames differ by ~1e-6 in fp32,
within 1e-4 dB and 1e-5 SSIM; the release weights' mean PSNR within 1e-3
dB.
"""

import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bin_tpu import metrics as jax_metrics
from bin_tpu.config import DataConfig as JaxDataConfig
from bin_tpu.config import ModelConfig as JaxModelConfig
from bin_tpu.config import get_config as jax_get_config
from bin_tpu.data.pipeline import SyntheticSource as JaxSource
from bin_tpu.data.pipeline import eval_clips as jax_eval_clips
from bin_tpu.evaluation import evaluator as jax_evaluator
from bin_tpu.registry import build_model as jax_build_model
from bin_tpu_torch import ModelConfig, build_model, metrics
from bin_tpu_torch.config import Config, DataConfig, apply_overrides
from bin_tpu_torch.data import SyntheticSource, eval_clips
from bin_tpu_torch.evaluation import evaluator
from bin_tpu_torch.weights import card_config, load_weights, read_card
from torch_params import one_torch_thread  # noqa: F401 (fixture)
from torch_params import random_flax_params

RELEASE = "weights/prf_ema_r4.npz"
SMALL = dict(base_features=8, num_res_blocks=1, convlstm_features=16)


@pytest.mark.parametrize("seed,size,style,batch", [
    (9999, (32, 32), "textured", 1), (5, (24, 40), "textured", 2),
    (9999, (24, 40), "smooth", 2), (5, (32, 32), "smooth", 1)])
def test_eval_clips_equal_bin_tpus_byte_for_byte(seed, size, style, batch):
    kw = dict(num_samples=3, num_keys=6, height=size[0], width=size[1],
              seed=seed, style=style)
    ours = list(eval_clips(SyntheticSource(**kw), batch_size=batch))
    theirs = list(jax_eval_clips(JaxSource(**kw), batch_size=batch))
    assert len(ours) == len(theirs) == (3 if batch == 1 else 2)
    for a, b in zip(ours, theirs):
        assert a.keys() == b.keys() == {"blurry", "sharp", "valid", "names"}
        assert a["names"] == b["names"]
        np.testing.assert_array_equal(a["valid"], b["valid"])
        for k in ("blurry", "sharp"):
            assert a[k].dtype == b[k].dtype == np.float32
            assert a[k].tobytes() == b[k].tobytes()
    assert ours[0]["blurry"].shape == (batch, 6, *size, 3)
    assert ours[0]["sharp"].shape == (batch, 11, *size, 3)
    assert ours[-1]["valid"].tolist() == ([True] if batch == 1
                                          else [True, False])
    with pytest.raises(IndexError):
        SyntheticSource(**kw)[3]


def _frames(shape, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0, 1, shape).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, shape), 0, 1).astype(np.float32)
    return a, b


@pytest.mark.parametrize("shape", [(11, 11, 3), (2, 40, 37, 3),
                                   (2, 3, 24, 30, 3), (1, 64, 64, 1)])
def test_psnr_and_ssim_equal_bin_tpus(shape):
    a, b = _frames(shape)
    for ours_fn, theirs_fn in ((metrics.psnr, jax_metrics.psnr),
                               (metrics.ssim, jax_metrics.ssim)):
        ours = ours_fn(torch.from_numpy(a), torch.from_numpy(b))
        theirs = np.asarray(theirs_fn(jnp.asarray(a), jnp.asarray(b)))
        assert tuple(ours.shape) == theirs.shape == shape[:-3]
        assert ours.dtype == torch.float32
        np.testing.assert_allclose(ours.numpy(), theirs, rtol=0, atol=1e-5)


def test_ssim_is_one_on_equal_frames_and_in_fp32_from_bf16():
    a, _ = _frames((2, 32, 32, 3), seed=1)
    x = torch.from_numpy(a)
    np.testing.assert_allclose(metrics.ssim(x, x).numpy(), 1.0, atol=1e-6)
    assert metrics.psnr(x, x).min() > 100  # the 1e-12 floor, not inf
    xb = x.to(torch.bfloat16)
    np.testing.assert_array_equal(metrics.ssim(xb, x).numpy(),
                                  metrics.ssim(xb.float(), x).numpy())


def test_ssim_refuses_frames_below_the_window():
    x = torch.zeros(1, 10, 32, 3)
    with pytest.raises(ValueError, match="window_size"):
        metrics.ssim(x, x)
    with pytest.raises(ValueError, match="window_size"):
        jax_metrics.ssim(jnp.zeros((1, 10, 32, 3)), jnp.zeros((1, 10, 32, 3)))
    assert metrics.gaussian_kernel().sum() == pytest.approx(1.0, abs=1e-6)
    np.testing.assert_array_equal(metrics.gaussian_kernel(7, 1.0),
                                  jax_metrics.gaussian_kernel(7, 1.0))


@pytest.fixture(scope="module")
def small_pair():
    """A small prf model of the port and of bin_tpu, on the same random
    parameters."""
    model = build_model(ModelConfig(**SMALL), device="cpu")
    params = random_flax_params(model.module)
    return (model.load_params(params), jax_build_model(JaxModelConfig(**SMALL)),
            params)


def _clips(n=2, keys=6, size=32, batch=1, seed=9999):
    return list(eval_clips(SyntheticSource(n, keys, size, size, seed=seed,
                                           style="textured"), batch))


@pytest.mark.parametrize("self_ensemble", [False, True])
def test_clip_metrics_equal_bin_tpus(small_pair, self_ensemble):
    model, jmodel, params = small_pair
    clip = _clips(n=2, batch=2)[0]
    fn, times = evaluator.clip_metrics_fn(model, 6,
                                          self_ensemble=self_ensemble)
    jfn, jtimes = jax_evaluator.clip_metrics_fn(
        jmodel, 6, self_ensemble=self_ensemble)
    np.testing.assert_array_equal(times, jtimes)
    ours = fn(clip["blurry"], clip["sharp"])
    theirs = jfn(params, jnp.asarray(clip["blurry"]),
                 jnp.asarray(clip["sharp"]))
    for metric, atol in (("psnr", 1e-4), ("ssim", 1e-5)):
        for cat in ("interp", "deblur", "overall"):
            a = ours[metric][cat].numpy()
            assert a.shape == (2,) and np.isfinite(a).all()
            np.testing.assert_allclose(a, np.asarray(theirs[metric][cat]),
                                       rtol=0, atol=atol)


@pytest.mark.parametrize("self_ensemble", [False, True])
def test_evaluate_equals_bin_tpus(small_pair, self_ensemble, capsys):
    """Means over 3 clips in batches of 2 (the last padded and masked)."""
    model, jmodel, params = small_pair
    clips = _clips(n=3, batch=2, seed=4)
    ours = evaluator.evaluate(model, clips, self_ensemble=self_ensemble)
    theirs = jax_evaluator.evaluate(jmodel, params, clips, verbose=False,
                                    self_ensemble=self_ensemble)
    assert sorted(ours) == sorted(theirs) == sorted(
        f"{m}_{c}" for m in ("psnr", "ssim")
        for c in ("interp", "deblur", "overall"))
    for k in ours:
        assert ours[k] == pytest.approx(theirs[k],
                                        abs=1e-4 if "psnr" in k else 1e-5)
    err = capsys.readouterr().err
    assert "synth4_0002:" in err and "== mean over 3 clips ==" in err


def test_evaluate_backbone_has_no_deblur_and_saves_frames(tmp_path):
    """A 1-level model predicts midpoints only: the deblur category is
    absent, as in bin_tpu; with save_dir the frames land as PNGs."""
    cfg = ModelConfig(**SMALL, name="backbone")
    model = build_model(cfg, device="cpu")
    params = random_flax_params(model.module)
    model.load_params(params)
    clips = _clips(n=1, keys=5)
    ours = evaluator.evaluate(model, clips, verbose=False,
                              save_dir=str(tmp_path))
    theirs = jax_evaluator.evaluate(
        jax_build_model(JaxModelConfig(**SMALL, name="backbone")), params,
        clips, verbose=False)
    assert sorted(ours) == sorted(theirs)
    assert "psnr_deblur" not in ours
    for k in ours:
        assert ours[k] == pytest.approx(theirs[k], abs=1e-4)
    pngs = sorted(p.name for p in (tmp_path / "synth9999_0000").iterdir())
    assert pngs == [f"t{t:06d}.png" for t in (1, 3, 5, 7)]


def test_release_weights_evaluate_equal_bin_tpus():
    """The release weights on one textured clip at 64x64 with 8 keys, fp32,
    through both evaluates."""
    params, cfg, _ = load_weights(RELEASE)
    from bin_tpu.weights import load_weights as jax_load_weights
    jparams, jcfg, _ = jax_load_weights(RELEASE)
    clips = _clips(n=1, keys=8, size=64)
    ours = evaluator.evaluate(build_model(cfg, "cpu").load_params(params),
                              clips, verbose=False)
    theirs = jax_evaluator.evaluate(jax_build_model(jcfg), jparams, clips,
                                    verbose=False)
    assert abs(ours["psnr_overall"] - theirs["psnr_overall"]) <= 1e-3
    assert abs(ours["ssim_overall"] - theirs["ssim_overall"]) <= 1e-5
    assert ours["psnr_overall"] > 20


def test_data_config_is_the_cards_pinned_protocol():
    proto = read_card(RELEASE)["metadata"]["eval_protocol"]
    d = DataConfig()
    assert list(d.eval_size) == proto["size"]
    assert (d.eval_num_clips, d.eval_num_keys, d.eval_seed,
            d.synthetic_style) == (proto["clips"], proto["keys"],
                                   proto["seed"], proto["style"])
    jd = JaxDataConfig()
    assert (d.blur_taps, d.blur_stride) == (jd.blur_taps, jd.blur_stride)
    for f in dataclasses.fields(DataConfig):
        assert hasattr(jd, f.name)


def test_apply_overrides_routes_data_and_model():
    cfg = apply_overrides(Config(), ["data.eval_size=64,48",
                                     "model.dtype=bfloat16",
                                     "data.eval_num_clips=2", "conv_int8=1"])
    assert cfg.data.eval_size == (64, 48) and cfg.data.eval_num_clips == 2
    assert cfg.model.dtype == "bfloat16" and cfg.model.conv_int8
    assert evaluator.off_protocol(cfg, 2) == ["eval_size", "eval_num_clips"]
    assert evaluator.off_protocol(Config(), 3) == ["num_clips"]
    with pytest.raises(KeyError, match="no_such_field"):
        apply_overrides(Config(), ["data.no_such_field=1"])
    assert apply_overrides(Config(), ["parallel.spatial_axis_size=2"]) \
        .parallel.spatial_axis_size == 2  # height sharding is taken
    # as in bin_tpu: a folder root is taken, whole clips without one are not
    assert apply_overrides(Config(), ["data.root=/frames"]).data.root == (
        jax_get_config("config3_prf", ["data.root=/frames"]).data.root)
    whole = apply_overrides(Config(), ["data.eval_num_keys=0"])
    with pytest.raises(ValueError, match="folder dataset"):
        evaluator.protocol_source(whole)


@pytest.mark.parametrize("serving", [False, True])
def test_cli_prints_one_json_line_on_cpu(capsys, serving):
    argv = ["--weights", RELEASE, "--device", "cpu", "--num-clips", "1",
            "--set", "data.eval_size=32,32", "--set", "data.eval_num_keys=5"]
    evaluator.main(argv + (["--serving"] if serving else []))
    captured = capsys.readouterr()
    out = captured.out.splitlines()
    assert len(out) == 1
    rec = json.loads(out[0])
    assert rec["mode"] == ("serving" if serving else "custom")
    assert rec["device"] == "cpu"
    assert rec["protocol"]["size"] == [32, 32]
    assert rec["protocol"]["keys"] == 6  # at least window_size + 2
    assert rec["protocol"]["dtype"] == ("bfloat16" if serving else "float32")
    assert rec["off_protocol"] == ["num_clips", "eval_size", "eval_num_keys"]
    assert rec["card_psnr_overall"] == pytest.approx(28.5775, abs=1e-4)
    assert 10 < rec["psnr_overall"] < 40 and 0 < rec["ssim_overall"] < 1
    assert ("eval protocol: preset=config3_prf size=32x32 clips=1 keys=6 "
            "seed=9999") in captured.err
    assert "[OFF-PROTOCOL: num_clips,eval_size,eval_num_keys]" in captured.err


def test_evaluate_cli_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = Config(model=card_config(RELEASE)[0])
    with pytest.raises(RuntimeError, match="CUDA"):
        evaluator.evaluate_cli(cfg, RELEASE)
    with pytest.raises(RuntimeError, match="CUDA"):
        evaluator.main(["--weights", RELEASE])
