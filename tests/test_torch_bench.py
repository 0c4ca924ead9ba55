"""The bench entry of the port (``bench_torch.py``,
``bin_tpu_torch/benchmark.py``) on the CPU: its serving constants and
overrides against ``bin_tpu``'s, and its one JSON line at a tiny size."""

import dataclasses
import json

import pytest

from bin_tpu.benchmark import SERVING_MODE as JAX_SERVING_MODE
from bin_tpu.benchmark import load_auto_overrides
from bin_tpu.config import apply_model_overrides as jax_apply_overrides
from bin_tpu_torch import benchmark
from bin_tpu_torch.config import ModelConfig, apply_model_overrides
from bin_tpu_torch.weights import load_weights

RELEASE = "weights/prf_ema_r4.npz"


@pytest.fixture(scope="module")
def cards():
    """The release card's model config, as the port and bin_tpu read it."""
    from bin_tpu.weights import load_weights as jax_load_weights
    return load_weights(RELEASE)[1], jax_load_weights(RELEASE)[1]


@pytest.mark.parametrize("weights", [RELEASE, "weights/prf_ema_r4_50k.npz"])
def test_serving_constants_match_bin_tpu(weights):
    """SERVING_MODE and the overrides of runs/BENCH_OVERRIDES.json, carried
    as the port's constants; the static scales are dropped for weights they
    were not calibrated for, as bin_tpu drops them."""
    assert benchmark.SERVING_MODE == JAX_SERVING_MODE
    theirs, _ = load_auto_overrides(weights_path=weights)
    assert benchmark.serving_overrides(weights) == theirs
    assert any("conv_int8_static" in s for s in theirs) == (weights == RELEASE)


@pytest.mark.parametrize("overrides", [
    [], ["model.conv_int8=false"], ["conv_int8_min_cin=512", "model.dtype=float32"],
    ["model.channel_mult=(1,2)", "model.conv_int8_lstm=1"]])
def test_apply_model_overrides_matches_bin_tpu(cards, overrides):
    card, jcard = cards
    ovs = [*JAX_SERVING_MODE, *benchmark.serving_overrides(RELEASE),
           *overrides]
    ours = apply_model_overrides(card, ovs)
    theirs = jax_apply_overrides(jcard, ovs)
    assert ours == ModelConfig(**{f.name: getattr(theirs, f.name)
                                  for f in dataclasses.fields(ModelConfig)})
    with pytest.raises(KeyError):
        apply_model_overrides(card, ["model.no_such_field=1"])


@pytest.mark.parametrize("argv,mode", [([], "serving"),
                                       (["--set", "model.conv_int8=false"],
                                        "bf16")])
def test_bench_entry_prints_one_json_line_on_cpu(capsys, argv, mode):
    benchmark.main(["--device", "cpu", "--height", "32", "--width", "32",
                    "--keys", "4", "--iters", "5", "--warmup", "1", *argv])
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 1
    rec = json.loads(out[0])
    assert set(rec) == {"metric", "value", "unit", "detail"}
    d = rec["detail"]
    assert d["mode"] == mode and d["device"] == "cpu"
    assert d["shape"] == [1, 4, 32, 32] and d["output_frames"] == 5
    assert len(d["run_ms"]) == 5 and d["spread_ms"] == [min(d["run_ms"]),
                                                        max(d["run_ms"])]
    assert rec["value"] == pytest.approx(5 / (d["median_ms"] / 1e3))
    assert d["peak_memory_bytes"] is None
    assert d["quality_note"].startswith("release weights/prf_ema_r4.npz")
    assert d["config"]["conv_int8"] == (mode == "serving")


def test_bench_entry_refuses_fewer_than_five_runs():
    with pytest.raises(ValueError, match="at least 5"):
        benchmark.main(["--device", "cpu", "--iters", "3"])




TINY_VARIANT = ["--stem", "4", "--base", "16", "--set",
                "model.num_res_blocks=1", "--set",
                "model.convlstm_features=16"]


def test_stem_base_variant_builds_config5_with_random_weights(capsys):
    """``--stem 4 --base 16`` (config5_v5e_streaming's variant, narrowed to
    run on the CPU): the config bin_tpu's bench builds from the same
    overrides, random weights, no quality note."""
    from bin_tpu.config import get_config as jax_get_config

    benchmark.main(["--device", "cpu", "--height", "32", "--width", "32",
                    "--keys", "4", "--iters", "5", "--warmup", "1",
                    *TINY_VARIANT])
    rec = json.loads(capsys.readouterr().out.strip())
    d = rec["detail"]
    assert d["weights"].startswith("random weights") and (
        "quality_note" not in d)
    # "custom": the --set narrowing departs from the serving mode's config
    assert d["mode"] == "custom" and d["model"].startswith(
        "prf stem4/base16 int8(min_cin=256, lstm, static)")
    extra, _ = load_auto_overrides()
    want = jax_get_config("config5_v5e_streaming", [
        "model.dtype=bfloat16", *JAX_SERVING_MODE[1:], "model.stem_factor=4",
        "model.base_features=16", *extra, "model.num_res_blocks=1",
        "model.convlstm_features=16"]).model
    for f in dataclasses.fields(ModelConfig):
        got = d["config"][f.name]
        assert (tuple(got) if isinstance(got, list) else got) == getattr(
            want, f.name), f.name


@pytest.mark.parametrize("drain", [["--drain-every", "4"], ["--async-drain"]])
def test_streaming_mode_prints_one_json_line_on_cpu(capsys, drain):
    benchmark.main(["--device", "cpu", "--height", "32", "--width", "32",
                    "--keys", "6", "--batch", "2", "--iters", "5",
                    "--streaming", *drain, *TINY_VARIANT])
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 1
    rec = json.loads(out[0])
    d = rec["detail"]
    # one stream of 5 x 6 keys a batch row, no flush: the first window
    # emits 3 frames, every later key 2
    assert d["frames_out"] == 2 * (2 * 30 - 5)
    assert d["batch_streams"] == 2 and d["input_dtype"] == "uint8"
    assert d["async_drain"] == (drain == ["--async-drain"])
    assert rec["value"] == pytest.approx(d["frames_out"] / d["seconds"])
    assert d["per_key_latency_ms"] == pytest.approx(d["seconds"] / 30 * 1e3)
