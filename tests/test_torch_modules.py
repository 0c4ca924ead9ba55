"""The port's modules against bin_tpu's on the CPU, in fp32: the same numpy
inputs and the same random parameters (drawn from a seed) on both sides.

Tolerances: the permutations are exact; the convolutions sum in another
order in the two frameworks, which leaves ~1e-6 per layer, hence 2e-5
through the backbone (as ``tests/test_parity_torch.py``).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bin_tpu.models.backbone import Backbone as JBackbone
from bin_tpu.models.convlstm import ConvLSTMCell as JCell
from bin_tpu.models.layers import Downsample as JDownsample
from bin_tpu.ops import fused_upsample as jfu
from bin_tpu.ops import resize as jresize
from bin_tpu.ops.pixel_shuffle import depth_to_space as jax_d2s
from bin_tpu.registry import build_model as jax_build_model
from bin_tpu.weights import load_weights as jax_load_weights
from bin_tpu_torch import build_model, config3_prf
from bin_tpu_torch.config import ModelConfig
from bin_tpu_torch.models.backbone import Backbone
from bin_tpu_torch.models.convlstm import ConvLSTMCell
from bin_tpu_torch.models.layers import Downsample, Upsample
from bin_tpu_torch.ops import fused_upsample, resize
from bin_tpu_torch.ops.pixel_shuffle import depth_to_space, space_to_depth
from bin_tpu_torch.weights import flatten, load_weights, params_from_flax
from torch_params import random_flax_params

RELEASE = "weights/prf_ema_r4.npz"


def _rand(*shape, seed=0, lo=0.0, hi=1.0):
    return np.random.default_rng(seed).uniform(lo, hi, shape).astype(np.float32)


def _load(module, params):
    module.load_state_dict(params_from_flax(params), strict=True)
    for m in module.modules():
        if isinstance(m, Upsample):
            m.prepare()
    return module.eval()


def _t(x):
    return torch.from_numpy(np.asarray(x))


def test_params_from_flax_release_bit_for_bit():
    params, cfg, _ = load_weights(RELEASE)
    jparams, jcfg, _ = jax_load_weights(RELEASE)
    assert cfg == ModelConfig(**{f.name: getattr(jcfg, f.name)
                                 for f in dataclasses.fields(ModelConfig)})
    flat = flatten(params)
    jflat = flatten(jparams)
    assert len(flat) == len(jflat) == 144
    sd = params_from_flax(params)
    assert len(sd) == 144
    for path, value in jflat.items():
        *mods, leaf = path.split("/")
        key = ".".join((*mods, "weight" if leaf == "kernel" else "bias"))
        want = value.transpose(3, 2, 0, 1) if leaf == "kernel" else value
        assert sd[key].dtype == torch.float32
        assert np.array_equal(sd[key].numpy(), want), path
    # the port's module takes exactly these 144 arrays
    model = build_model(cfg, device="cpu")
    assert set(model.module.state_dict()) == set(sd)
    assert sum(v.numel() for v in sd.values()) == 96_094_500


def test_config3_prf_is_the_release_architecture():
    _, cfg, _ = load_weights(RELEASE)
    assert dataclasses.replace(cfg, stem_factor=2) == config3_prf()


def test_upsample2x_matches_bin_tpu():
    x = _rand(2, 5, 7, 4)
    np.testing.assert_allclose(resize.upsample2x(_t(x)).numpy(),
                               np.asarray(jresize.upsample2x(jnp.asarray(x))),
                               rtol=0, atol=1e-6)


def test_phase_kernel_matches_bin_tpu():
    w = np.random.default_rng(1).normal(0, 1, (3, 3, 4, 6)).astype(np.float32)
    ours = fused_upsample.phase_kernel(_t(w.transpose(3, 2, 0, 1)))
    theirs = np.asarray(jfu.phase_kernel(jnp.asarray(w)))
    np.testing.assert_allclose(ours.numpy(), theirs.transpose(3, 2, 0, 1),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("size", [(6, 6), (5, 9)])
def test_upsample2x_conv_matches_reference_and_bin_tpu(size):
    rng = np.random.default_rng(2)
    x = _rand(2, *size, 4)
    w = rng.normal(0, 0.3, (3, 3, 4, 6)).astype(np.float32)
    b = rng.normal(0, 0.3, (6,)).astype(np.float32)
    wt, bt = _t(w.transpose(3, 2, 0, 1)), _t(b)
    fused = fused_upsample.upsample2x_conv(
        _t(x), fused_upsample.phase_kernel(wt), bt.repeat(4))
    ref = fused_upsample.upsample2x_conv_reference(_t(x), wt, bt)
    theirs = jfu.upsample2x_conv(jnp.asarray(x), jnp.asarray(w),
                                 jnp.asarray(b))
    assert fused.shape == (2, 2 * size[0], 2 * size[1], 6)
    np.testing.assert_allclose(fused.numpy(), ref.numpy(), rtol=0, atol=2e-5)
    np.testing.assert_allclose(fused.numpy(), np.asarray(theirs), rtol=0,
                               atol=2e-5)


@pytest.mark.parametrize("size", [(8, 12), (7, 9)])
def test_downsample_flax_same_padding(size):
    """Stride-2 SAME pads (0, 1) on an even side and (1, 1) on an odd one;
    torch's padding=1 would shift every output pixel."""
    x = _rand(2, *size, 4)
    ours = Downsample(4, 8)
    params = random_flax_params(ours)
    theirs = np.asarray(JDownsample(8).apply({"params": params},
                                             jnp.asarray(x)))
    ours = _load(ours, params)(_t(x))
    assert ours.shape == theirs.shape == (2, -(-size[0] // 2),
                                          -(-size[1] // 2), 8)
    np.testing.assert_allclose(ours.detach().numpy(), theirs, rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("stem", [1, 2])
@pytest.mark.parametrize("clamp", [False, True])
def test_backbone_matches_bin_tpu(stem, clamp):
    cpk = 3 * stem * stem
    h, w = 32 // stem, 48 // stem
    a, b = _rand(2, h, w, cpk), _rand(2, h, w, cpk, seed=1)
    ctx = _rand(2, h // 4, w // 4, 16, seed=2, lo=-1)
    ours = Backbone(8, (1, 2, 4), 2, 0.1, stem, context_features=16)
    params = random_flax_params(ours)
    jm = JBackbone(base_features=8, num_res_blocks=2, stem_factor=stem)
    sharp_j, feats_j = jm.apply({"params": params}, jnp.asarray(a),
                                jnp.asarray(b), jnp.asarray(ctx),
                                clamp_output=clamp)
    ours = _load(ours, params)
    with torch.no_grad():
        sharp_t, feats_t = ours(_t(a), _t(b), _t(ctx), clamp_output=clamp)
    np.testing.assert_allclose(feats_t.numpy(), np.asarray(feats_j), rtol=0,
                               atol=2e-5)
    np.testing.assert_allclose(sharp_t.numpy(), np.asarray(sharp_j), rtol=0,
                               atol=2e-5)


def test_backbone_tail_is_zero_init():
    bb = Backbone(8, stem_factor=2, context_features=16)
    assert not bb.tail.weight.any() and not bb.tail.bias.any()


def test_convlstm_two_steps_of_carried_state():
    x1, x2 = _rand(1, 6, 8, 32, seed=1), _rand(1, 6, 8, 32, seed=2)
    h0 = _rand(1, 6, 8, 16, seed=3, lo=-1)
    c0 = _rand(1, 6, 8, 16, seed=4, lo=-1)
    ours = ConvLSTMCell(32, 16)
    params = {"params": random_flax_params(ours)}
    jm = JCell(features=16)
    ours = _load(ours, params["params"])
    js = (jnp.asarray(h0), jnp.asarray(c0))
    ts = (_t(h0), _t(c0))
    with torch.no_grad():
        for x in (x1, x2):
            js = jm.apply(params, jnp.asarray(x), js)
            ts = ours(_t(x), ts)
            for o, j in zip(ts, js):
                assert o.dtype == torch.float32
                np.testing.assert_allclose(o.numpy(), np.asarray(j), rtol=0,
                                           atol=1e-5)


@pytest.mark.parametrize("factor", [1, 2, 4])
def test_depth_to_space_matches_bin_tpu(factor):
    x = _rand(2, 3, 4, 5 * factor * factor)
    assert np.array_equal(depth_to_space(_t(x), factor).numpy(),
                          np.asarray(jax_d2s(jnp.asarray(x), factor)))


@pytest.mark.parametrize("stem", [1, 2])
def test_pyramid_window_matches_bin_tpu(stem):
    """One window through the port's pyramid (packed by the port) against
    bin_tpu's ``apply_window`` on the unpacked window, both clamping on the
    producer side as inference does."""
    kw = dict(name="prf", base_features=8, num_res_blocks=1,
              convlstm_features=16, stem_factor=stem)
    from bin_tpu.config import ModelConfig as JConfig
    jmodel = jax_build_model(JConfig(**kw))
    model = build_model(ModelConfig(**kw), device="cpu")
    params = random_flax_params(model.module)
    window = _rand(1, 4, 32, 32, 3, seed=5) * 2.4 - 0.7  # crosses the clamp
    hb = 32 // (stem * 4)
    states = [(_rand(1, hb, hb, 16, seed=10 + i, lo=-1),
               _rand(1, hb, hb, 16, seed=20 + i, lo=-1)) for i in range(3)]
    outs_j, st_j = jmodel.apply_window(
        params, jnp.asarray(window),
        [(jnp.asarray(h), jnp.asarray(c)) for h, c in states],
        producer_clamp=True)
    model.load_params(params)
    with torch.no_grad():
        outs_t, st_t = model.module(
            space_to_depth(_t(window), stem),
            [(_t(h), _t(c)) for h, c in states])
    for o, j in zip(outs_t, outs_j):
        np.testing.assert_allclose(o.numpy(), np.asarray(j), rtol=0,
                                   atol=2e-5)
    for (h, c), (hj, cj) in zip(st_t, st_j):
        np.testing.assert_allclose(h.numpy(), np.asarray(hj), rtol=0,
                                   atol=2e-5)
        np.testing.assert_allclose(c.numpy(), np.asarray(cj), rtol=0,
                                   atol=2e-5)
