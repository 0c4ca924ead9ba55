"""``python -m bin_tpu_torch.cli`` on the CPU at a tiny width, against
``bin_tpu``: every preset field by field, a worker-loader train on a
frame-folder tree whose resumed run replays the uninterrupted run's
batches (as ``tests/test_grain_resume.py``), the whole-clip eval's metrics
and protocol line, ``log.debug_nans``, and each command of the CLI."""

import dataclasses
import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bin_tpu.config import PRESETS as JAX_PRESETS
from bin_tpu.config import get_config as jax_get_config
from bin_tpu.data.frames import FrameFolderSource as JaxFolderSource
from bin_tpu.data.pipeline import eval_clips as jax_eval_clips
from bin_tpu.evaluation import evaluator as jax_evaluator
from bin_tpu.registry import build_model as jax_build_model
from bin_tpu.training.state import TrainState as JaxTrainState
from bin_tpu.training.state import make_optimizer
from bin_tpu.training.trainer import make_train_step as jax_train_step
from bin_tpu.weights import load_weights as jax_load_weights
from bin_tpu_torch import build_model, cli
from bin_tpu_torch.config import PRESETS, get_config, unported_training_fields
from bin_tpu_torch.data import synthetic
from bin_tpu_torch.data.blur import synthesize_tree
from bin_tpu_torch.evaluation import evaluator
from bin_tpu_torch.training import trainer
from bin_tpu_torch.training.state import create_train_state, warm_start
from bin_tpu_torch.weights import export_weights, load_weights, read_card
from torch_params import one_torch_thread  # noqa: F401 (fixture)
from torch_params import random_flax_params

TINY = ["model.base_features=8", "model.num_res_blocks=1",
        "model.convlstm_features=16"]
TRAIN = [*TINY, "data.crop_size=32,32", "data.batch_size=2",
         "checkpoint.save_interval_steps=2", "checkpoint.keep_last_n=2",
         "log.log_interval_steps=1"]


def _sets(sets: list[str]) -> list[str]:
    return [a for s in sets for a in ("--set", s)]


@pytest.fixture(autouse=True)
def grad_enabled():
    """``tests/torch_twin.py`` turns grad mode off where it is imported."""
    with torch.enable_grad():
        yield


# Fields that only one package has: bin_tpu's layout switches, which pick
# between bit-exact TPU layouts (the port has one layout), its master-weight
# dtype (always fp32 in the port) and Orbax's asynchronous save (the port
# writes torch.save files).
ONLY_BIN_TPU = {
    "model": {"s2d_via_conv", "d2s_via_conv", "d2s_final_via_conv",
              "fused_upsample", "param_dtype"},
    "checkpoint": {"async_save"}}


@pytest.mark.parametrize("preset", sorted(JAX_PRESETS))
def test_every_preset_equals_bin_tpus_field_by_field(preset):
    assert sorted(PRESETS) == sorted(JAX_PRESETS)
    ours, theirs = get_config(preset), JAX_PRESETS[preset]()
    assert (ours.preset, ours.seed) == (theirs.preset, theirs.seed)
    for f in dataclasses.fields(theirs):
        if f.name in ("preset", "seed"):
            continue
        a, b = getattr(ours, f.name), getattr(theirs, f.name)
        names_a = {g.name for g in dataclasses.fields(a)}
        names_b = {g.name for g in dataclasses.fields(b)}
        assert names_b - names_a == ONLY_BIN_TPU.get(f.name, set())
        assert names_a <= names_b, f"{f.name}: {names_a - names_b}"
        for name in names_a:
            assert getattr(a, name) == getattr(b, name), f"{f.name}.{name}"


# --- the tree and the train CLI ----------------------------------------------

@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """Two tiny clips prepped by the port's tool: 5 and 6 keys, 32x32."""
    root = tmp_path_factory.mktemp("cli")
    for clip_id, seed, n in (("clipA", 1, 43), ("clipB", 2, 51)):
        d = root / "raw" / clip_id
        d.mkdir(parents=True)
        for i, frame in enumerate(synthetic.render_sharp_clip(seed, n, 32, 32)):
            np.save(d / f"{i:06d}.npy", (frame * 255 + 0.5).astype(np.uint8))
    synthesize_tree(str(root / "raw"), str(root / "tree"), verbose=False)
    return str(root / "tree")


def _losses(workdir: str) -> dict[int, float]:
    with open(os.path.join(workdir, "metrics.jsonl")) as f:
        return {r["step"]: r["loss_total"] for r in map(json.loads, f)
                if "loss_total" in r}


def _train(tree, workdir, steps, loader, capsys, *extra):
    cli.main(["train", "--preset", "config4_gopro_720p", "--device", "cpu",
              "--steps", str(steps), "--workdir", workdir,
              *_sets([*TRAIN, f"data.root={tree}", "data.seq_len=4",
                      loader, *extra])])
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("loader", ["data.num_workers=2", "data.loader=grain"])
def test_resumed_train_replays_the_uninterrupted_batches(tree, tmp_path,
                                                         capsys, loader):
    """config4 on the folder tree with the worker loader (2 workers, or
    in-process): 6 steps straight against 2 + 2 + 2 resumed twice; the
    in-training eval on the tree's clips keeps best.npz."""
    straight = str(tmp_path / "straight")
    rec = _train(tree, straight, 6, loader, capsys,
                 "log.eval_interval_steps=3", "data.eval_num_keys=6",
                 "data.eval_size=32,32")
    assert rec == {"step": 6, "workdir": straight, "checkpoint": 6,
                   "skipped_steps": 0}
    want = _losses(straight)
    assert sorted(want) == list(range(1, 7))
    meta = read_card(os.path.join(straight, "best.npz"))["metadata"]
    assert meta["eval_size"] == [32, 32] and meta["eval_clips"] == 4
    loader_dir = os.path.join(straight, "checkpoints_loader")
    assert sorted(os.listdir(loader_dir)) == ["4.bin", "6.bin"]  # keep 2
    assert json.loads(open(os.path.join(loader_dir, "6.bin")).read())[
        "next_batch"] == 6

    resumed = str(tmp_path / "resumed")
    for steps in (2, 4, 6):
        _train(tree, resumed, steps, loader, capsys)
    got = _losses(resumed)
    assert sorted(got) == list(range(1, 7))
    for step in range(1, 7):
        assert got[step] == want[step], f"step {step} diverged on resume"


def test_resume_without_the_loader_state_warns(tree, tmp_path, capsys):
    wd = str(tmp_path / "run")
    _train(tree, wd, 2, "data.num_workers=1", capsys)
    os.remove(os.path.join(wd, "checkpoints_loader", "2.bin"))
    with pytest.warns(UserWarning, match="exact replay broken"):
        _train(tree, wd, 3, "data.num_workers=1", capsys)


def test_training_settings_of_this_slice_are_taken():
    cfg = get_config("config4_gopro_720p", ["data.num_workers=4",
                                            "data.loader=grain",
                                            "log.debug_nans=true",
                                            "data.root=/frames"])
    assert unported_training_fields(cfg) == []
    assert cfg.data.root == "/frames"


# --- log.debug_nans --------------------------------------------------------------

def test_debug_nans_raises_where_bin_tpus_raises():
    """A clean step and a step with a NaN in the batch, in both packages
    (config1_backbone_128, tiny): neither raises on the clean one, both
    raise FloatingPointError on the NaN one; the port's state keeps the
    clean step's values.  (bin_tpu checks a jitted step's outputs on its
    first call only, so each of its steps here is a fresh function; the
    port checks every step.)"""
    sets = [*TINY, "data.batch_size=1", "log.debug_nans=true"]
    cfg = get_config("config1_backbone_128", sets)
    jcfg = jax_get_config("config1_backbone_128", sets)
    model = build_model(cfg.model, "cpu")
    params = random_flax_params(model.module, seed=3)
    rng = np.random.default_rng(0)
    clean = {"blurry": rng.uniform(0, 1, (1, 4, 32, 32, 3)).astype(np.float32),
             "sharp": rng.uniform(0, 1, (1, 7, 32, 32, 3)).astype(np.float32)}
    nan = {k: v.copy() for k, v in clean.items()}
    nan["blurry"][0, 1, 2, 3, 0] = np.nan

    opt = make_optimizer(jcfg.optim)
    p = jax.tree.map(jnp.asarray, params)
    jstate = JaxTrainState(step=jnp.zeros((), jnp.int32), params=p,
                           opt_state=opt.init(p), ema_params=None)
    jax.config.update("jax_debug_nans", True)
    try:
        for batch, raises in ((clean, False), (nan, True)):
            # a fresh step each: after a jitted function's first call, JAX's
            # fast dispatch path no longer checks its outputs for NaN
            jstep = jax_train_step(jax_build_model(jcfg), jcfg)
            state_in = jax.tree.map(jnp.copy, jstate)
            if raises:
                with pytest.raises(FloatingPointError):
                    jstep(state_in, jax.tree.map(jnp.asarray, batch))
            else:
                jstep(state_in, jax.tree.map(jnp.asarray, batch))
    finally:
        jax.config.update("jax_debug_nans", False)

    state = warm_start(create_train_state(cfg, model), params)
    step = trainer.make_train_step(model, cfg)
    state, _ = step(state, {k: torch.from_numpy(v) for k, v in clean.items()})
    before = state.params.clone()
    with pytest.raises(FloatingPointError, match="step 2"):
        step(state, {k: torch.from_numpy(v) for k, v in nan.items()})
    assert state.step == 1 and torch.equal(state.params, before)


# --- the whole-clip eval -----------------------------------------------------------

@pytest.fixture(scope="module")
def small_weights(tmp_path_factory):
    """Random weights of config4's model at the tiny width, as a release
    .npz, and the flax tree."""
    cfg = get_config("config4_gopro_720p", TINY)
    params = random_flax_params(build_model(cfg.model, "cpu").module, seed=5)
    path = str(tmp_path_factory.mktemp("w") / "small.npz")
    export_weights(path, params, cfg.model, {"preset": cfg.preset})
    return path, params


def test_whole_clip_eval_equals_bin_tpus(tree, small_weights, capsys):
    """`cli eval` of whole clips (5 and 6 keys: one function per length)
    against bin_tpu's evaluate on the same tree and weights, fp32, within
    the eval tests' 1e-4 dB and 1e-5."""
    path, params = small_weights
    sets = [*TINY, f"data.root={tree}", "data.eval_num_keys=0",
            "data.eval_size=32,32"]
    cli.main(["eval", "--preset", "config4_gopro_720p", "--device", "cpu",
              "--checkpoint", path, *_sets(sets)])
    captured = capsys.readouterr()
    ours = json.loads(captured.out.strip().splitlines()[-1])
    assert ("eval protocol: preset=config4_gopro_720p size=32x32 clips=16 "
            "keys=whole seed=9999 dtype=float32 [OFF-PROTOCOL: eval_size]"
            in captured.err)
    assert "clipA:" in captured.err and "== mean over 2 clips ==" in captured.err
    jcfg = jax_get_config("config4_gopro_720p", sets)
    source = JaxFolderSource(tree, num_keys=None, resize_to=(32, 32))
    theirs = jax_evaluator.evaluate(jax_build_model(jcfg), params,
                                    jax_eval_clips(source), verbose=False)
    assert sorted(ours) == sorted(theirs) and len(ours) == 6
    for k in ours:
        assert ours[k] == pytest.approx(theirs[k],
                                        abs=1e-4 if "psnr" in k else 1e-5)


@pytest.mark.parametrize("preset,sets,num_clips,se", [
    ("config1_backbone_128", ["data.eval_size=32,32", "data.eval_num_keys=0",
                              "ROOT"], None, False),
    ("config1_backbone_128", ["data.eval_num_keys=6", "ROOT"], 3, False),
    ("config4_gopro_720p", [], None, False),
    ("config3_prf", ["data.eval_size=64,64"], 2, True)])
def test_protocol_line_equals_bin_tpus(tree, preset, sets, num_clips, se,
                                       capsys, monkeypatch):
    """The line both print before they evaluate (the eval itself, and
    bin_tpu's random init, are stubbed): OFF-PROTOCOL against the preset's
    own eval size."""
    sets = [*TINY, *(f"data.root={tree}" if s == "ROOT" else s for s in sets)]
    if any(s.startswith("data.root") for s in sets):
        sets.append("data.dataset=gopro")
    monkeypatch.setattr(evaluator, "evaluate", lambda *a, **k: {})
    monkeypatch.setattr(jax_evaluator, "evaluate", lambda *a, **k: {})
    monkeypatch.setattr(jax_evaluator, "build_model", lambda cfg: (
        types.SimpleNamespace(init=lambda *a, **k: None)))
    evaluator.evaluate_cli(get_config(preset, sets), num_clips=num_clips,
                           self_ensemble=se, device="cpu")
    ours = [ln for ln in capsys.readouterr().err.splitlines()
            if ln.startswith("eval protocol:")]
    jax_evaluator.evaluate_cli(jax_get_config(preset, sets),
                               num_clips=num_clips, self_ensemble=se)
    theirs = [ln for ln in capsys.readouterr().out.splitlines()
              if ln.startswith("eval protocol:")]
    assert len(ours) == 1 and ours == theirs


def test_whole_clips_need_a_folder_dataset_in_both(monkeypatch):
    monkeypatch.setattr(jax_evaluator, "build_model", lambda cfg: (
        types.SimpleNamespace(init=lambda *a, **k: None)))
    for get, mod in ((get_config, evaluator), (jax_get_config, jax_evaluator)):
        cfg = get("config4_gopro_720p", [*TINY, "data.eval_num_keys=0"])
        with pytest.raises(ValueError, match="folder dataset"):
            mod.evaluate_cli(cfg, **({"device": "cpu"} if mod is evaluator
                                     else {}))


# --- export, demo, bench ----------------------------------------------------------

def test_export_cli_writes_a_card_bin_tpu_loads(tree, tmp_path, capsys):
    wd = str(tmp_path / "run")
    _train(tree, wd, 2, "data.num_workers=0", capsys, "optim.ema_decay=0.9")
    record = tmp_path / "eval.json"
    record.write_text(json.dumps({"model": {"psnr_overall": 20.5,
                                            "ssim_overall": 0.7},
                                  "protocol": {"size": [32, 32]}}))
    out = str(tmp_path / "exp.npz")
    cli.main(["export", "--preset", "config4_gopro_720p", *_sets(TINY),
              "--checkpoint", os.path.join(wd, "checkpoints"), "--ema",
              "--out", out, "--note", "tiny", "--store-dtype", "float16",
              "--eval-json", str(record)])
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec == {"out": out, "preset": "config4_gopro_720p", "ema": True,
                   "psnr_overall": 20.5}
    params, model_cfg, meta = load_weights(out)
    jparams, jcfg, jmeta = jax_load_weights(out)
    assert meta == jmeta and meta["note"] == "tiny" and meta["ema"] is True
    assert meta["eval_protocol"] == {"size": [32, 32]}
    assert read_card(out)["store_dtype"] == "float16"
    assert model_cfg.base_features == jcfg.base_features == 8
    flat = jax.tree_util.tree_leaves(jparams)
    assert all(a.dtype == np.float32 for a in flat)


def test_demo_cli_on_a_folder_a_video_and_synthetic(tree, small_weights,
                                                    tmp_path, capsys):
    path, params = small_weights
    model = build_model(get_config("config4_gopro_720p", TINY).model,
                        "cpu").load_params(params)
    folder = os.path.join(tree, "blurry", "clipB")
    cli.main(["demo", "--weights", path, "--input", folder, "--device", "cpu",
              "--out", str(tmp_path / "a")])
    assert "wrote 9 sharp frames (2x rate, times 1..9)" in (
        capsys.readouterr().out)
    from PIL import Image
    from bin_tpu_torch.data.frames import load_frame
    blurry = np.stack([load_frame(os.path.join(folder, f))
                       for f in sorted(os.listdir(folder))])[None]
    video, times = model.infer_clip(torch.from_numpy(blurry))
    for frame, t in zip(video[0].numpy(), times):
        want = (np.clip(frame, 0, 1) * 255 + 0.5).astype(np.uint8)
        got = np.asarray(Image.open(tmp_path / "a" / "demo" / f"t{t:06d}.png"))
        np.testing.assert_array_equal(got, want)

    cli.main(["demo", "--weights", path, "--device", "cpu", "--size", "32",
              "32", "--keys", "4", "--out", str(tmp_path / "b")])
    assert len(os.listdir(tmp_path / "b" / "demo")) == 5
    cv2 = pytest.importorskip("cv2")
    vid = str(tmp_path / "clip.avi")
    w = cv2.VideoWriter(vid, cv2.VideoWriter_fourcc(*"FFV1"), 30.0, (32, 32))
    if not w.isOpened():
        pytest.skip("FFV1 codec unavailable in this OpenCV build")
    for f in blurry[0]:
        w.write((f[..., ::-1] * 255 + 0.5).astype(np.uint8))
    w.release()
    cli.main(["demo", "--weights", path, "--input", vid, "--device", "cpu",
              "--out", str(tmp_path / "c")])
    assert len(os.listdir(tmp_path / "c" / "demo")) == 9


@pytest.mark.parametrize("frames,match", [
    ([(32, 32)] * 3, "need >= 4 frames"),
    ([(32, 32)] * 3 + [(32, 40)], "differing sizes"),
    ([(36, 32)] * 4, "not divisible by 8")])
def test_demo_validates_its_input(small_weights, tmp_path, frames, match):
    path, _ = small_weights
    for i, (h, w) in enumerate(frames):
        np.save(tmp_path / f"{i:06d}.npy", np.zeros((h, w, 3), np.uint8))
    with pytest.raises(SystemExit, match=match):
        cli.main(["demo", "--weights", path, "--input", str(tmp_path),
                  "--device", "cpu", "--out", str(tmp_path / "o")])


def test_bench_cli_prints_the_bench_line(capsys):
    cli.main(["bench", "--device", "cpu", "--height", "32", "--width", "32",
              "--keys", "4", "--iters", "5", "--warmup", "1", "--set",
              "model.conv_int8=false"])
    rec = json.loads(capsys.readouterr().out.strip())
    assert rec["detail"]["mode"] == "bf16" and rec["detail"]["device"] == "cpu"


def test_commands_and_the_card(tmp_path):
    assert sorted(cli.COMMANDS) == sorted(
        ["train", "eval", "bench", "prep", "extract", "export", "demo",
         "import-torch"])
    with pytest.raises(SystemExit, match="usage"):
        cli.main(["serve"])
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for argv in (["train", "--steps", "1", "--workdir", str(tmp_path)],
                 ["eval"],
                 ["demo", "--weights", "weights/prf_ema_r4.npz"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main([*argv, *(_sets(TINY) if argv[0] != "demo" else [])])
