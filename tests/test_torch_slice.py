"""The port's main path, ``infer_clip``, against bin_tpu's on the CPU in
fp32, on the same numpy clip and the same parameters; and the port's rules:
no JAX and no bin_tpu inside it, CUDA by default, and a smoke script that
fails where there is no card.

Tolerance 5e-5: the two frameworks sum the convolutions in another order,
~1e-6 per conv, through three pyramid levels and the recurrence.
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
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 10
    banned = ("jax", "jaxlib", "flax", "optax", "orbax", "bin_tpu")
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
