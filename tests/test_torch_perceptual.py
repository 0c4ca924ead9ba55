"""The port's VGG-16 perceptual loss (``bin_tpu_torch/perceptual.py``) on the
CPU against ``bin_tpu/perceptual.py``: the fixed-seed filters bit for bit,
the features at every tap, the loss and its gradient, the torchvision
``state_dict`` import from a ``.pth`` and an ``.npz`` with the same errors,
a tiny config3 ``loss_clip`` with ``perceptual_mode=vgg`` and its gradient,
and ``cli train`` with the VGG term.

Inputs come from numpy seeds.  Tolerances: the features within atol 2e-4
and rtol 1e-4 (``tests/test_perceptual.py``'s bounds: fp32 convs summed in
another order); the loss within 1e-5 relative and its gradient with
respect to ``pred`` within 1e-4 relative L2; ``loss_clip`` and its
gradient leaf by leaf within ``tests/test_torch_training.py``'s bounds
(1e-5 relative, 1e-4 relative L2), or a leaf within twice ``bin_tpu``'s
own move under a 1 + 1e-7 input scale where that is larger (the VGG
term's kinks; measured in the test's docstring).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bin_tpu import perceptual as jax_perceptual
from bin_tpu.config import get_config as jax_get_config
from bin_tpu.losses import build_perceptual_fn as jax_build_perceptual_fn
from bin_tpu.registry import build_model as jax_build_model
from bin_tpu_torch import build_model, cli, losses, perceptual
from bin_tpu_torch.config import get_config
from bin_tpu_torch.weights import flatten, flax_from_params
from torch_params import one_torch_thread  # noqa: F401 (fixture)
from torch_params import random_flax_params

TINY = ["model.base_features=8", "model.num_res_blocks=1",
        "model.convlstm_features=16", "data.crop_size=32,32",
        "data.batch_size=2", "data.seq_len=5"]
TAPS = tuple(perceptual.LAYER_TAPS.values())


@pytest.fixture(autouse=True)
def grad_enabled():
    """Grad mode on: ``tests/torch_twin.py`` turns it off at import, and
    the suite's workers import every test module."""
    with torch.enable_grad():
        yield


def _rel_l2(ours, theirs) -> float:
    ours, theirs = np.asarray(ours, np.float64), np.asarray(theirs, np.float64)
    return float(np.linalg.norm(ours - theirs)
                 / max(np.linalg.norm(theirs), 1e-30))


def _state_dict(params, prefix="features."):
    """A torchvision-style state_dict of [(kernel HWIO, bias)]: conv i at
    its features index, OIHW."""
    sd, idx, conv = {}, 0, 0
    for c in perceptual.VGG16_CHANNELS:
        if conv == len(params):
            break
        if c == "M":
            idx += 1
            continue
        k, b = params[conv]
        sd[f"{prefix}{idx}.weight"] = np.ascontiguousarray(
            np.asarray(k).transpose(3, 2, 0, 1))
        sd[f"{prefix}{idx}.bias"] = np.asarray(b)
        idx += 2
        conv += 1
    return sd


def _assert_params_equal(ours, theirs):
    assert len(ours) == len(theirs)
    for (k, b), (jk, jb) in zip(ours, theirs):
        assert np.array_equal(k, np.asarray(jk))
        assert np.array_equal(b, np.asarray(jb))


@pytest.mark.parametrize("num_convs", [2, None])
@pytest.mark.parametrize("seed", [0, 1, 7])
def test_init_vgg16_params_equals_bin_tpus(seed, num_convs):
    ours = perceptual.init_vgg16_params(seed, num_convs)
    theirs = jax_perceptual.init_vgg16_params(seed, num_convs)
    assert len(ours) == (num_convs or 13)
    _assert_params_equal(ours, theirs)
    assert all(k.dtype == np.float32 and b.dtype == np.float32
               for k, b in ours)


@pytest.fixture(scope="module")
def features_case():
    params = perceptual.init_vgg16_params(seed=3)
    x = np.random.default_rng(5).uniform(0, 1, (2, 16, 16, 3)).astype(
        np.float32)
    want = jax_perceptual.vgg16_features(
        [(jnp.asarray(k), jnp.asarray(b)) for k, b in params],
        jnp.asarray(x), TAPS)
    return params, x, [np.asarray(f) for f in want]


@pytest.mark.parametrize("tap", list(perceptual.LAYER_TAPS))
def test_vgg16_features_match_bin_tpu_at_every_tap(features_case, tap):
    params, x, want = features_case
    vgg = perceptual.VGG16(params)
    assert all(w.is_contiguous(memory_format=torch.channels_last)
               and not w.requires_grad for w in vgg.weights)
    with torch.no_grad():
        got = vgg(torch.from_numpy(x), TAPS)
    i = TAPS.index(perceptual.LAYER_TAPS[tap])
    assert got[i].shape == want[i].shape
    np.testing.assert_allclose(got[i].numpy(), want[i], atol=2e-4, rtol=1e-4)


@pytest.mark.parametrize("layers,weights", [
    (("relu1_2", "relu2_2", "relu3_3"), None),
    (("relu2_2", "relu4_3"), (0.25, 2.0))])
def test_loss_and_gradient_match_bin_tpu(layers, weights):
    deepest = max(perceptual.LAYER_TAPS[n] for n in layers)
    params = perceptual.init_vgg16_params(seed=0, num_convs=deepest + 1)
    rng = np.random.default_rng(11)
    pred = rng.uniform(0, 1, (1, 3, 16, 16, 3)).astype(np.float32)
    target = rng.uniform(0, 1, (1, 3, 16, 16, 3)).astype(np.float32)
    jfn = jax_perceptual.make_perceptual_fn(
        jax_perceptual.init_vgg16_params(seed=0, num_convs=deepest + 1),
        layers, weights)
    jloss, jgrad = jax.value_and_grad(jfn)(jnp.asarray(pred),
                                            jnp.asarray(target))
    fn = perceptual.make_perceptual_fn(params, layers, weights)
    p = torch.from_numpy(pred).requires_grad_()
    loss = fn(p, torch.from_numpy(target))
    loss.backward()
    assert loss.dtype == torch.float32
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    assert _rel_l2(p.grad.numpy(), jgrad) <= 1e-4
    assert fn(p, p).item() == 0.0


@pytest.mark.parametrize("fmt", ["pth", "npz"])
def test_load_vgg16_params_from_pth_and_npz(tmp_path, fmt):
    params = perceptual.init_vgg16_params(seed=2, num_convs=4)
    path = str(tmp_path / f"vgg.{fmt}")
    if fmt == "pth":  # the full model's keys
        torch.save({k: torch.from_numpy(v)
                    for k, v in _state_dict(params).items()}, path)
    else:  # a bare nn.Sequential's
        np.savez(path, **_state_dict(params, prefix=""))
    for num_convs in (4, 3):
        ours = perceptual.load_vgg16_params(path, num_convs)
        _assert_params_equal(ours, params[:num_convs])
        _assert_params_equal(
            ours, jax_perceptual.load_vgg16_params(path, num_convs))


def test_state_dict_errors_equal_bin_tpus():
    sd = _state_dict(perceptual.init_vgg16_params(seed=0, num_convs=3))
    for broken, exc in (
            ({k: v for k, v in sd.items() if k != "features.5.bias"},
             KeyError),
            ({**sd, "features.2.weight": sd["features.2.weight"][:, :5]},
             ValueError)):
        with pytest.raises(exc) as ours:
            perceptual.torch_state_to_params(broken, num_convs=3)
        with pytest.raises(exc) as theirs:
            jax_perceptual.torch_state_to_params(broken, num_convs=3)
        assert str(ours.value) == str(theirs.value)


def test_vgg_weights_file_gives_the_fallbacks_loss(tmp_path):
    """``loss.vgg_weights``: a ``.pth`` written from the seed-0 fallback
    gives the loss of the fallback itself."""
    from bin_tpu_torch.config import LossConfig

    path = str(tmp_path / "vgg16.pth")
    torch.save({k: torch.from_numpy(v) for k, v in _state_dict(
        perceptual.init_vgg16_params(seed=0)).items()}, path)
    rng = np.random.default_rng(3)
    a, b = (torch.from_numpy(rng.uniform(0, 1, (2, 16, 16, 3)).astype(
        np.float32)) for _ in range(2))
    cfg = LossConfig(perceptual_weight=0.5, perceptual_mode="vgg")
    fallback = losses.build_perceptual_fn(cfg, "cpu")
    loaded = losses.build_perceptual_fn(
        LossConfig(perceptual_weight=0.5, perceptual_mode="vgg",
                   vgg_weights=path), "cpu")
    with torch.no_grad():
        assert loaded(a, b).item() == fallback(a, b).item() > 0


def test_loss_clip_with_vgg_matches_bin_tpu():
    """The VGG term's ReLUs and max-pools are kinks: an activation within
    rounding of a ReLU's zero, or two pooled values within rounding of each
    other, route the gradient one way or the other.  On this clip
    ``bin_tpu``'s own gradient moves by 1.03e-3 (relative L2, the
    ``lstm_1`` gates) when its input is scaled by 1 + 1e-7, where the
    port differs from it by 9.2e-4.  So each leaf is held within 1e-4, or
    within twice ``bin_tpu``'s own move under that scale where that is
    larger."""
    sets = [*TINY, "loss.perceptual_weight=0.5", "loss.perceptual_mode=vgg"]
    cfg, jcfg = (get_config("config3_prf", sets),
                 jax_get_config("config3_prf", sets))
    model = build_model(cfg.model, "cpu")
    params = random_flax_params(model.module, seed=4)
    rng = np.random.default_rng(8)
    blurry = rng.uniform(0, 1, (2, 5, 32, 32, 3)).astype(np.float32)
    sharp = rng.uniform(0, 1, (2, 9, 32, 32, 3)).astype(np.float32)
    jfn = jax_build_perceptual_fn(jcfg.loss)
    jmodel = jax_build_model(jcfg)
    jgrad = jax.jit(jax.value_and_grad(
        lambda p, b: jmodel.loss_clip(p, b, jnp.asarray(sharp), jcfg.loss,
                                      jfn), has_aux=True))
    (jloss, jaux), jgrads = jgrad(params, jnp.asarray(blurry))
    _, jmoved = jgrad(params, jnp.asarray(blurry * np.float32(1 + 1e-7)))
    jgrads = flatten(jax.device_get(jgrads))
    jmoved = flatten(jax.device_get(jmoved))
    model.train_params(params)
    loss, aux = model.loss_clip(torch.from_numpy(blurry),
                                torch.from_numpy(sharp), cfg.loss,
                                losses.build_perceptual_fn(cfg.loss, "cpu"))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(aux["loss_perceptual"].item(),
                               float(jaux["loss_perceptual"]), rtol=1e-5)
    grads = flatten(flax_from_params(
        {n: p.grad for n, p in model.module.named_parameters()}))
    assert sorted(grads) == sorted(jgrads)
    over = {k: (_rel_l2(grads[k], jgrads[k]), _rel_l2(jmoved[k], jgrads[k]))
            for k in jgrads}
    over = {k: v for k, v in over.items() if v[0] > max(1e-4, 2 * v[1])}
    assert not over, over


def test_cli_train_with_the_vgg_term_on_cpu(tmp_path, capsys):
    wd = str(tmp_path / "run")
    cli.main(["train", "--preset", "config3_prf_extended", "--device", "cpu",
              "--steps", "2", "--workdir", wd, "--set",
              "loss.perceptual_mode=vgg", "--set", "log.log_interval_steps=1",
              *sum((["--set", s] for s in TINY), [])])
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["step"] == 2 and rec["skipped_steps"] == 0
    with open(os.path.join(wd, "metrics.jsonl")) as f:
        logged = [json.loads(line) for line in f]
    assert [r["step"] for r in logged] == [1, 2]
    assert all(np.isfinite(r["loss_perceptual"]) and r["loss_perceptual"] > 0
               for r in logged)
