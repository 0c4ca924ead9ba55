"""The port's main path, ``infer_clip``, against bin_tpu's on the CPU in
fp32, on the same numpy clip and the same parameters, and on the release
weights in bf16 and in the int8 serving mode; and the port's rules: no JAX
and no bin_tpu inside it, CUDA by default, and a smoke script that fails
where there is no card.

Tolerance 5e-5 in fp32: the two frameworks sum the convolutions in another
order, ~1e-6 per conv, through three pyramid levels and the recurrence.
bf16 and int8 are held by PSNR and a max abs diff, each stated with its
test.
"""

import ast
import dataclasses
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bin_tpu.config import ModelConfig as JaxModelConfig
from bin_tpu.registry import build_model as jax_build_model
from bin_tpu.weights import load_weights as jax_load_weights
from bin_tpu_torch import ModelConfig, build_model
from bin_tpu_torch.config import apply_model_overrides
from bin_tpu_torch.models.recurrent import assembly_plan
from bin_tpu_torch.weights import load_weights
from torch_params import random_flax_params

REPO = pathlib.Path(__file__).resolve().parent.parent
SMALL = dict(base_features=16, num_res_blocks=2, convlstm_features=32)


def _clip(keys, size, seed=3):
    return np.random.default_rng(seed).uniform(
        0, 1, (1, keys, size, size, 3)).astype(np.float32)


def _compare(jcfg, tcfg, params, jparams, clip, atol):
    video_j, times_j = jax_build_model(jcfg).infer_clip(jparams,
                                                        jnp.asarray(clip))
    video_t, times_t = build_model(tcfg, device="cpu").load_params(
        params).infer_clip(torch.from_numpy(clip))
    assert list(times_t) == list(times_j)
    assert video_t.dtype == torch.float32
    assert tuple(video_t.shape) == video_j.shape
    np.testing.assert_allclose(video_t.numpy(), np.asarray(video_j), rtol=0,
                               atol=atol)


@pytest.mark.parametrize("name,stem", [("prf", 2), ("prf", 1),
                                       ("pyramid", 2), ("backbone", 2)])
def test_infer_clip_matches_bin_tpu_small(name, stem):
    kw = dict(SMALL, name=name, stem_factor=stem)
    cfg = ModelConfig(**kw)
    params = random_flax_params(build_model(cfg, device="cpu").module)
    _compare(JaxModelConfig(**kw), cfg, params, params, _clip(8, 64), 5e-5)


def test_infer_clip_matches_bin_tpu_release_weights():
    params, cfg, _ = load_weights("weights/prf_ema_r4.npz")
    jparams, jcfg, _ = jax_load_weights("weights/prf_ema_r4.npz")
    assert cfg.dtype == jcfg.dtype == "float32"
    _compare(jcfg, cfg, params, jparams, _clip(6, 32), 5e-5)


def _psnr(a, b):
    """PSNR at peak 1 of the videos clipped to [0, 1], as evaluation
    clips them."""
    a, b = np.clip(a, 0, 1).astype(np.float64), np.clip(b, 0, 1)
    return 10 * np.log10(1.0 / np.mean((a - b) ** 2))


def _release_pair(overrides):
    from bin_tpu.config import apply_model_overrides as jax_overrides
    params, cfg, _ = load_weights("weights/prf_ema_r4.npz")
    jparams, jcfg, _ = jax_load_weights("weights/prf_ema_r4.npz")
    return (params, apply_model_overrides(cfg, overrides), jparams,
            jax_overrides(jcfg, overrides))


def _run_both(params, cfg, jparams, jcfg, clip):
    video_j, _ = jax_build_model(jcfg).infer_clip(jparams, jnp.asarray(clip))
    video_t, _ = build_model(cfg, device="cpu").load_params(
        params).infer_clip(torch.from_numpy(clip))
    return video_t.float().numpy(), np.asarray(video_j).astype(np.float32)


def test_bf16_matches_bin_tpu_bf16_release_weights():
    """bf16 rounds at other places in the two frameworks: 49.49 dB and a
    max abs diff of 0.0234 (one bf16 step near 1) measured on this clip;
    the bound leaves 1.5 dB under it."""
    ours, theirs = _run_both(*_release_pair(["model.dtype=bfloat16"]),
                             _clip(8, 64))
    assert _psnr(ours, theirs) >= 48.0
    assert np.abs(ours - theirs).max() <= 0.05


# bin_tpu's int8 conv is one XLA conv with int8 operands, which runs on the
# CPU some 100x slower than its float conv (77 s for this test at 64x64
# with 8 keys), hence 32x32 with 6 keys (3 windows of recurrence).
@pytest.mark.parametrize("dtype,min_psnr,atol", [("bfloat16", 45.0, 0.05),
                                                 ("float32", 50.0, 0.03)])
def test_serving_mode_matches_bin_tpu_release_weights(dtype, min_psnr, atol):
    """The serving mode (SERVING_MODE plus the int8 gate conv and the
    static scales) against bin_tpu's.  Each int8 conv is bit-exact given
    the same input (tests/test_torch_quant.py), but the float convs sum in
    another order, and a difference of an ulp flips the rounding of an
    activation at a .5 boundary now and then; the flip then moves a whole
    neighbourhood downstream.  bin_tpu itself moves by 0.0101 in fp32 when
    its input is scaled by 1 + 1e-7.  Measured: fp32 max abs diff 0.0107,
    56.18 dB; bf16 0.0234, 48.49 dB."""
    from bin_tpu_torch.benchmark import SERVING_MODE, serving_overrides
    overrides = [*SERVING_MODE, *serving_overrides("weights/prf_ema_r4.npz"),
                 f"model.dtype={dtype}"]
    params, cfg, jparams, jcfg = _release_pair(overrides)
    assert cfg.conv_int8 and cfg.conv_int8_lstm and jcfg.conv_int8_static
    ours, theirs = _run_both(params, cfg, jparams, jcfg, _clip(6, 32))
    assert _psnr(ours, theirs) >= min_psnr
    assert np.abs(ours - theirs).max() <= atol


def test_assembly_plan_matches_bin_tpu():
    from bin_tpu.models.recurrent import assembly_plan as jax_plan
    for keys, window, levels in [(8, 4, 3), (6, 4, 3), (12, 4, 3),
                                 (5, 4, 2), (4, 4, 1), (9, 5, 4)]:
        assert assembly_plan(keys, window, levels) == jax_plan(keys, window,
                                                               levels)


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        build_model(ModelConfig(**SMALL))


def test_bf16_runs_and_stays_in_range():
    cfg = ModelConfig(**SMALL, dtype="bfloat16")
    params = random_flax_params(build_model(cfg, device="cpu").module)
    video, times = build_model(cfg, device="cpu").load_params(
        params).infer_clip(torch.from_numpy(_clip(6, 32)))
    assert video.dtype == torch.float32 and list(times) == list(range(1, 10))
    assert torch.isfinite(video).all()
    assert video.min() >= -0.5 and video.max() <= 1.5
    f32, _ = build_model(dataclasses.replace(cfg, dtype="float32"),
                         device="cpu").load_params(params).infer_clip(
        torch.from_numpy(_clip(6, 32)))
    assert (video - f32).abs().max() < 0.1


def _imports(path: pathlib.Path) -> set[str]:
    mods = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            mods.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods.add(node.module)
    return mods


def test_port_imports_no_jax_and_no_bin_tpu():
    files = sorted((REPO / "bin_tpu_torch").rglob("*.py"))
    files += [REPO / "chip_smoke.py", REPO / "bench_torch.py"]
    assert len(files) > 10
    assert {REPO / "bin_tpu_torch" / f for f in (
        "cli.py", "data/frames.py", "data/blur.py", "data/video.py",
        "data/loader.py", "perceptual.py", "import_torch.py",
        "parallel/__init__.py", "parallel/mesh.py",
        "parallel/distributed.py")} <= set(files)
    banned = ("jax", "jaxlib", "flax", "optax", "orbax", "grain", "bin_tpu")
    for path in files:
        for mod in _imports(path):
            root = mod.split(".")[0]
            assert root not in banned, f"{path.relative_to(REPO)} imports {mod}"


def test_chip_smoke_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")],
                          cwd=REPO, capture_output=True, text=True, timeout=60)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
