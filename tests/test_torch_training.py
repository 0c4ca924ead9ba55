"""The port's training path on the CPU against ``bin_tpu``'s: K1's and K2's
gradients, the int8 ops' refusal of gradients, the losses, ``loss_clip``
and its gradient leaf by leaf, the train step (one and three steps, the
skip of a non-finite step, gradient accumulation, the schedule), the
overfit check, checkpoints, the export to ``bin_tpu``, ``Model.init`` and
the trainer's entry; the bf16 step against ``bin_tpu``'s (bounds measured,
stated with them), the in-training eval and ``best.npz``, the stall
watchdog and the profiler hook.

Sizes are tiny (base 8, one mid ResBlock, ConvLSTM F=16, 32x32 crops,
batch 2, 5 keys), parameters come from ``tests/torch_params.py`` and inputs
from numpy seeds, fp32 throughout.  Tolerances: the gate VJP within 1e-6
(fp32 elementwise, another order of operations); the pack's gradient
bit-exact (a permutation); the losses within 2e-6 relative of bin_tpu's
and the Charbonnier within 1e-6 relative of a float64 numpy mean
(bin_tpu's fp32 mean on the CPU is itself up to ~1e-6 from the float64
one, the port's within ~5e-8); ``loss_clip``
within 1e-5 relative and each gradient leaf within 1e-4 relative L2 (the
two frameworks sum the convs in other orders); the train steps hold the
parameters' moves within 1e-3 of a step on elements whose gradient is
well above rounding, where Adam's normalized step follows the gradient's
sign (elements with a gradient near zero take +-lr from rounding noise,
and are counted, not compared).
"""

import dataclasses
import json
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bin_tpu import losses as jax_losses
from bin_tpu.config import get_config as jax_get_config
from bin_tpu.models.convlstm import lstm_gate_math
from bin_tpu.ops.pallas.lstm_gates import fused_lstm_gates as pallas_gates
from bin_tpu.ops.pallas.s2d_pack import space_to_depth_pallas
from bin_tpu.registry import build_model as jax_build_model
from bin_tpu.training.state import TrainState as JaxTrainState
from bin_tpu.training.state import make_lr_schedule as jax_schedule
from bin_tpu.training.state import make_optimizer
from bin_tpu.training.trainer import make_train_step as jax_train_step
from bin_tpu.weights import load_weights as jax_load_weights
from bin_tpu_torch import build_model, losses
from bin_tpu_torch.config import (LossConfig, OptimConfig, get_config,
                                  unported_training_fields)
from bin_tpu_torch.ops import lstm_gates, pixel_shuffle, quant
from bin_tpu_torch.training import checkpoint as ckpt
from bin_tpu_torch.training import trainer
from bin_tpu_torch.training.state import (create_train_state,
                                          make_lr_schedule, warm_start)
from bin_tpu_torch.weights import (export_weights, flatten, flax_from_params,
                                   load_weights)
from torch_params import one_torch_thread  # noqa: F401 (fixture)
from torch_params import random_flax_params

TINY = ["model.base_features=8", "model.num_res_blocks=1",
        "model.convlstm_features=16", "data.crop_size=32,32",
        "data.batch_size=2", "data.seq_len=5"]


@pytest.fixture(autouse=True)
def grad_enabled():
    """Grad mode on for each test: ``tests/torch_twin.py`` turns it off when
    it is imported, and the suite's workers import every test module."""
    with torch.enable_grad():
        yield


def _cfgs(*extra):
    """The port's and bin_tpu's config3_prf at the tiny size."""
    return (get_config("config3_prf", [*TINY, *extra]),
            jax_get_config("config3_prf", [*TINY, *extra]))


def _rel_l2(ours, theirs) -> float:
    ours, theirs = np.asarray(ours, np.float64), np.asarray(theirs, np.float64)
    return float(np.linalg.norm(ours - theirs)
                 / max(np.linalg.norm(theirs), 1e-30))


def _batch(seed=0, b=2, k=5, hw=32, lo=0.0, hi=1.0):
    rng = np.random.default_rng(seed)
    return {"blurry": rng.uniform(lo, hi, (b, k, hw, hw, 3)).astype(np.float32),
            "sharp": rng.uniform(lo, hi, (b, 2 * k - 1, hw, hw, 3)
                                 ).astype(np.float32)}


# --- K1's backward, K2's gradient, the int8 ops ----------------------------

@pytest.mark.parametrize("bias", [1.0, 0.0])
def test_lstm_gates_backward_matches_bin_tpu(bias):
    rng = np.random.default_rng(3)
    gates = rng.normal(0, 3, (2, 6, 5, 64)).astype(np.float32)
    c = rng.normal(0, 1, (2, 6, 5, 16)).astype(np.float32)
    dh = rng.normal(0, 1, c.shape).astype(np.float32)
    dc = rng.normal(0, 1, c.shape).astype(np.float32)
    g_t = torch.from_numpy(gates).requires_grad_()
    c_t = torch.from_numpy(c).requires_grad_()
    h2, c2 = lstm_gates.fused_lstm_gates(g_t, c_t, bias)
    torch.autograd.backward((h2, c2), (torch.from_numpy(dh),
                                       torch.from_numpy(dc)))
    for fn in (lambda g, cc: pallas_gates(g, cc, bias, True),
               lambda g, cc: lstm_gate_math(g, cc, bias)):
        _, vjp = jax.vjp(fn, jnp.asarray(gates), jnp.asarray(c))
        dg_j, dc_j = vjp((jnp.asarray(dh), jnp.asarray(dc)))
        np.testing.assert_allclose(g_t.grad.numpy(), np.asarray(dg_j),
                                   rtol=0, atol=1e-6)
        np.testing.assert_allclose(c_t.grad.numpy(), np.asarray(dc_j),
                                   rtol=0, atol=1e-6)


def test_lstm_gates_backward_bf16_rounds_once():
    """bf16 gates: dgates is the fp32 VJP rounded once to bf16."""
    rng = np.random.default_rng(4)
    gates = torch.from_numpy(rng.normal(0, 3, (3, 64)).astype(np.float32))
    c, dh, dc = (torch.from_numpy(rng.normal(0, 1, (3, 16)).astype(
        np.float32)) for _ in range(3))
    dg16, dc16 = lstm_gates.lstm_gates_bwd_ref(gates.bfloat16(), c, dh, dc)
    dg32, dc32 = lstm_gates.lstm_gates_bwd_ref(gates.bfloat16().float(), c,
                                               dh, dc)
    assert dg16.dtype == torch.bfloat16 and dc16.dtype == torch.float32
    assert torch.equal(dg16, dg32.bfloat16()) and torch.equal(dc16, dc32)


def test_lstm_gates_saves_inputs_and_counts_no_cpu_launch():
    before = (lstm_gates.launches, lstm_gates.bwd_launches)
    g = torch.randn(2, 64, requires_grad=True)
    c = torch.randn(2, 16)
    h2, c2 = lstm_gates.fused_lstm_gates(g, c)
    assert h2.grad_fn is not None and c2.grad_fn is h2.grad_fn
    saved = h2.grad_fn.saved_tensors
    assert saved[0] is g or torch.equal(saved[0], g)
    assert torch.equal(saved[1], c)
    (h2.sum() + c2.sum()).backward()
    assert (lstm_gates.launches, lstm_gates.bwd_launches) == before


@pytest.fixture
def claims_cuda(monkeypatch):
    """Tensors that report CUDA on a machine without a GPU (meta tensors
    carry shapes and dtypes but no data)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))


def test_k1b_on_cuda_tensors_launches_or_raises(claims_cuda):
    """The backward of CUDA tensors goes to K1b (here: the library, which
    raises without a card), never to the plain version."""
    meta = dict(device="meta")
    ctx = mock.Mock(forget_bias=1.0, saved_tensors=(
        torch.empty(1, 4, 4, 64, dtype=torch.bfloat16, **meta),
        torch.empty(1, 4, 4, 16, **meta)))
    dh = torch.empty(1, 4, 4, 16, **meta)
    with mock.patch.object(lstm_gates, "lstm_gates_bwd_ref",
                           side_effect=AssertionError("plain version")):
        with pytest.raises(RuntimeError, match="CUDA device"):
            lstm_gates.FusedLSTMGates.backward(ctx, dh, dh)
        with pytest.raises(ValueError, match="cotangents|float32"):
            lstm_gates.FusedLSTMGates.backward(
                ctx, torch.empty(1, 4, 4, 15, **meta), dh)


@pytest.mark.parametrize("factor,shape", [(2, (2, 3, 8, 12, 3)),
                                          (4, (2, 16, 8, 5))])
def test_space_to_depth_gradient_matches_bin_tpu(factor, shape):
    rng = np.random.default_rng(5)
    x = rng.normal(0, 1, shape).astype(np.float32)
    out_shape = (*shape[:-3], shape[-3] // factor, shape[-2] // factor,
                 shape[-1] * factor * factor)
    ct = rng.normal(0, 1, out_shape).astype(np.float32)
    x_t = torch.from_numpy(x).requires_grad_()
    y = pixel_shuffle.space_to_depth(x_t, factor)
    y.backward(torch.from_numpy(ct))
    _, vjp = jax.vjp(lambda a: space_to_depth_pallas(a, factor, True),
                     jnp.asarray(x))
    (dx,) = vjp(jnp.asarray(ct))
    assert np.array_equal(x_t.grad.numpy(), np.asarray(dx))


def test_int8_ops_refuse_inputs_that_require_grad():
    x = torch.rand(1, 4, 4, 32, requires_grad=True)
    w, s = quant.quantize_weight(torch.randn(8, 32, 3, 3))
    scale = torch.tensor(0.01)
    with pytest.raises(RuntimeError, match="no backward"):
        quant.quantize_act(x, scale)
    with pytest.raises(RuntimeError, match="no backward"):
        quant.int8_conv(x, w, s, None, 1, (1, 1), 0.01)
    bias = torch.zeros(8, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        quant.int8_conv(x.detach(), w, s, bias, 1, (1, 1), 0.01)
    with torch.no_grad():  # inference: fine
        assert quant.int8_conv(x, w, s, bias, 1, (1, 1), 0.01).shape == (
            1, 4, 4, 8)


# --- losses ------------------------------------------------------------------

@pytest.mark.parametrize("perceptual,cycle", [(0.0, 0.1), (0.5, 0.1),
                                              (0.5, 0.0)])
def test_losses_match_bin_tpu(perceptual, cycle):
    rng = np.random.default_rng(6)
    k, f = 4, 2
    outs = [rng.uniform(-0.2, 1.2, (2, k - 1 - l, 8, 8, 12)).astype(np.float32)
            for l in range(3)]
    gt = rng.uniform(0, 1, (2, 2 * k - 1, 8, 8, 12)).astype(np.float32)
    cfg = LossConfig(perceptual_weight=perceptual, cycle_weight=cycle)
    jcfg = jax_get_config("config3_prf").loss
    jcfg = dataclasses.replace(jcfg, perceptual_weight=perceptual,
                               cycle_weight=cycle)
    total, aux = losses.pyramid_loss([torch.from_numpy(o) for o in outs],
                                     torch.from_numpy(gt), cfg, k, f)
    jtotal, jaux = jax_losses.pyramid_loss([jnp.asarray(o) for o in outs],
                                           jnp.asarray(gt), jcfg, k, f)
    assert sorted(aux) == sorted(jaux)
    for key in jaux:
        np.testing.assert_allclose(float(aux[key]), float(jaux[key]),
                                   rtol=2e-6, err_msg=key)
    np.testing.assert_allclose(float(total), float(jtotal), rtol=2e-6)
    a, b = torch.from_numpy(outs[0]), torch.from_numpy(gt[:, :3])
    np.testing.assert_allclose(
        float(losses.charbonnier(a, b)),
        float(jax_losses.charbonnier(jnp.asarray(outs[0]),
                                     jnp.asarray(gt[:, :3]))), rtol=2e-6)
    exact = np.sqrt((outs[0].astype(np.float64) - gt[:, :3]) ** 2
                    + 1e-12).mean()
    np.testing.assert_allclose(float(losses.charbonnier(a, b)), exact,
                               rtol=1e-6)
    np.testing.assert_allclose(
        float(losses.gradient_loss(a, b)),
        float(jax_losses.gradient_loss(jnp.asarray(outs[0]),
                                       jnp.asarray(gt[:, :3]))), rtol=2e-6)


def test_vgg_perceptual_raises_until_ported():
    """Ported: ``perceptual_mode=vgg`` builds the VGG loss (its fixed-seed
    filters up to the deepest tap); only an unknown mode raises."""
    fn = losses.build_perceptual_fn(LossConfig(perceptual_weight=0.5,
                                               perceptual_mode="vgg"), "cpu")
    assert len(fn.vgg.weights) == 7  # relu3_3 is conv 6
    with pytest.raises(ValueError, match="unknown perceptual_mode"):
        losses.build_perceptual_fn(LossConfig(perceptual_weight=0.5,
                                              perceptual_mode="lpips"), "cpu")


# --- loss_clip and its gradient ------------------------------------------------

@pytest.fixture(scope="module")
def clip_case():
    """One clip whose values leave [-0.5, 1.5] (so the consume-side clamp
    acts), random parameters, and bin_tpu's loss and gradient of it, with
    the gradient perceptual term on."""
    cfg, jcfg = _cfgs("loss.perceptual_weight=0.5")
    model = build_model(cfg.model, "cpu")
    params = random_flax_params(model.module, seed=7)
    batch = _batch(1, lo=-0.8, hi=1.8)
    jmodel = jax_build_model(jcfg)
    (loss, aux), grads = jax.value_and_grad(
        lambda p: jmodel.loss_clip(p, jnp.asarray(batch["blurry"]),
                                   jnp.asarray(batch["sharp"]), jcfg.loss),
        has_aux=True)(params)
    return cfg, params, batch, (float(loss), jax.device_get(aux),
                                flatten(jax.device_get(grads)))


@pytest.mark.parametrize("remat", [False, True])
def test_loss_clip_and_gradient_match_bin_tpu(clip_case, remat):
    cfg, params, batch, (jloss, jaux, jgrads) = clip_case
    mcfg = dataclasses.replace(cfg.model, remat=remat)
    model = build_model(mcfg, "cpu").train_params(params)
    loss, aux = model.loss_clip(torch.from_numpy(batch["blurry"]),
                                torch.from_numpy(batch["sharp"]), cfg.loss)
    loss.backward()
    np.testing.assert_allclose(loss.item(), jloss, rtol=1e-5)
    assert sorted(aux) == sorted(jaux)
    for key in jaux:
        np.testing.assert_allclose(aux[key].item(), float(jaux[key]),
                                   rtol=1e-5)
    grads = flatten(flax_from_params(
        {n: p.grad for n, p in model.module.named_parameters()}))
    assert sorted(grads) == sorted(jgrads)
    worst = max((_rel_l2(grads[k], jgrads[k]), k) for k in jgrads)
    assert worst[0] <= 1e-4, worst
    # the clamp acted: without it the loss is another
    free = build_model(dataclasses.replace(mcfg, clamp_intermediate=False),
                       "cpu").train_params(params)
    with torch.no_grad():
        other, _ = free.loss_clip(torch.from_numpy(batch["blurry"]),
                                  torch.from_numpy(batch["sharp"]), cfg.loss)
    assert abs(other.item() - jloss) > 1e-4 * abs(jloss)


def test_unpacked_window_is_packed_inside():
    cfg, _ = _cfgs()
    model = build_model(cfg.model, "cpu")
    model.train_params(random_flax_params(model.module, seed=2))
    x = torch.from_numpy(_batch(2)["blurry"][:, :4])
    states = model.initial_state(2, 32, 32)
    with torch.no_grad():
        a, _ = model.module(x, states, producer_clamp=False)
        b, _ = model.module(pixel_shuffle.space_to_depth(x.contiguous(), 2),
                            states, producer_clamp=False)
    assert all(torch.equal(p, q) for p, q in zip(a, b))


# --- train steps ---------------------------------------------------------------

def _jax_state(jcfg, params):
    opt = make_optimizer(jcfg.optim)
    p = jax.tree.map(jnp.asarray, params)
    return JaxTrainState(
        step=jnp.zeros((), jnp.int32), params=p, opt_state=opt.init(p),
        ema_params=(jax.tree.map(jnp.copy, p)
                    if jcfg.optim.ema_decay > 0 else None))


def _torch_state(cfg, params):
    model = build_model(cfg.model, "cpu")
    state = warm_start(create_train_state(cfg, model), params)
    return model, state


STEP_SETS = ["optim.learning_rate=1e-3", "optim.ema_decay=0.9",
             "optim.weight_decay=0.01"]


@pytest.fixture(scope="module")
def step_case():
    """Three bin_tpu train steps on one batch, from random parameters,
    AdamW with clipping (the gradient norm is far above 1.0) and an EMA;
    then a NaN batch.  The port takes the batch as u8; bin_tpu takes it
    divided by 255 already (the same fp32 values its u8 path makes), so
    that one compiled step serves both batches."""
    cfg, jcfg = _cfgs(*STEP_SETS)
    params = random_flax_params(build_model(cfg.model, "cpu").module, seed=9)
    rng = np.random.default_rng(8)
    batch = {"blurry": rng.integers(0, 256, (2, 5, 32, 32, 3), np.uint8),
             "sharp": rng.integers(0, 256, (2, 9, 32, 32, 3), np.uint8)}
    fbatch = {k: v.astype(np.float32) / np.float32(255) for k, v in
              batch.items()}
    nan_batch = {k: v.copy() for k, v in fbatch.items()}
    nan_batch["blurry"][0, 0, 0, 0, 0] = np.nan
    jmodel = jax_build_model(jcfg)
    step = jax_train_step(jmodel, jcfg)
    state = _jax_state(jcfg, params)
    out = []
    for _ in range(3):
        state, aux = step(state, jax.tree.map(jnp.asarray, fbatch))
        out.append((jax.device_get(state), jax.device_get(aux)))
    state, aux = step(state, jax.tree.map(jnp.asarray, nan_batch))
    return cfg, params, batch, nan_batch, out, (jax.device_get(state),
                                                jax.device_get(aux))


def _compare_moves(ours, theirs, start, grads, lr, what):
    """Hold ``ours`` and ``theirs`` (flat {path: array}) as moves from
    ``start``, within 1e-3 of lr, on elements whose first gradient is above
    1e-5; return the count of sign flips there."""
    flips = 0
    for key in theirs:
        mask = np.abs(grads[key]) > 1e-5
        d_o = (ours[key] - start[key])[mask]
        d_t = (np.asarray(theirs[key]) - start[key])[mask]
        np.testing.assert_allclose(d_o, d_t, rtol=0, atol=1e-3 * lr,
                                   err_msg=f"{what} {key}")
        flips += int(np.sum(np.sign(d_o) != np.sign(d_t)))
    return flips


def test_one_and_three_train_steps_match_bin_tpu(step_case):
    cfg, params, batch, _, jout, _ = step_case
    model, state = _torch_state(cfg, params)
    step = trainer.make_train_step(model, cfg)
    start = flatten(params)
    grads = None
    lr = cfg.optim.learning_rate
    for i in range(3):
        state, aux = step(state, {k: torch.from_numpy(v)
                                  for k, v in batch.items()})
        if i == 0:  # the first step's raw gradient, for the masks
            grads = flatten(flax_from_params(state.named(state.grads)))
        jstate, jaux = jout[i]
        assert sorted(aux) == sorted(jaux)
        for key in jaux:
            np.testing.assert_allclose(aux[key].item(), float(jaux[key]),
                                       rtol=1e-5, err_msg=key)
        if i in (0, 2):
            ours = flatten(flax_from_params(state.named(state.params)))
            flips = _compare_moves(ours, flatten(jstate.params), start,
                                   grads, lr, f"step {i + 1} params")
            assert flips == 0, flips
            ema = flatten(flax_from_params(state.named(state.ema)))
            _compare_moves(ema, flatten(jstate.ema_params), start, grads,
                           lr, f"step {i + 1} ema")
    assert state.step == 3 and int(state.count) == 3
    jcount = jout[2][0].opt_state.inner_state[1][0].count
    assert int(state.count) == int(jcount)


def test_nonfinite_step_is_skipped_as_optax_does(step_case):
    cfg, params, batch, nan_batch, jout, (jnan, jnan_aux) = step_case
    model, state = _torch_state(cfg, params)
    step = trainer.make_train_step(model, cfg)
    for _ in range(3):
        state, _ = step(state, {k: torch.from_numpy(v)
                                for k, v in batch.items()})
    before = {k: getattr(state, k).clone()
              for k in ("params", "mu", "nu", "count", "ema")}
    state, aux = step(state, {k: torch.from_numpy(v)
                              for k, v in nan_batch.items()})
    assert not np.isfinite(aux["grad_norm"].item())
    assert not np.isfinite(float(jnan_aux["grad_norm"]))
    for k in ("params", "mu", "nu", "count"):
        assert torch.equal(getattr(state, k), before[k]), k
    d = cfg.optim.ema_decay
    assert torch.equal(state.ema, before["ema"] * d + before["params"] * (1 - d))
    assert state.step == 4
    jfin = jnan.opt_state
    assert int(state.notfinite_count) == int(jfin.notfinite_count) == 1
    assert int(state.total_notfinite) == int(jfin.total_notfinite) == 1
    assert bool(state.last_finite) == bool(jfin.last_finite) is False
    # bin_tpu leaves its parameters as they were too
    for a, b in zip(jax.tree.leaves(jnan.params),
                    jax.tree.leaves(jout[2][0].params)):
        assert np.array_equal(np.asarray(a), np.asarray(b))


def test_train_step_ignores_the_callers_grad_mode():
    cfg, _ = _cfgs()
    params = random_flax_params(build_model(cfg.model, "cpu").module, seed=6)
    batch = {k: torch.from_numpy(v) for k, v in _batch(6).items()}
    results = []
    for grad in (True, False):
        model, state = _torch_state(cfg, params)
        with torch.set_grad_enabled(grad):
            state, aux = trainer.make_train_step(model, cfg)(state, batch)
        results.append((state.params, aux["grad_norm"]))
    assert torch.equal(results[0][0], results[1][0])
    assert torch.equal(results[0][1], results[1][1]) and results[0][1] > 0


def test_grad_accumulation_equals_the_unsplit_step():
    cfg, _ = _cfgs("data.batch_size=4", "optim.ema_decay=0.9")
    params = random_flax_params(build_model(cfg.model, "cpu").module, seed=3)
    batch = {k: torch.from_numpy(v) for k, v in _batch(4, b=4).items()}
    results = []
    for accum in (1, 2):
        c = dataclasses.replace(cfg, optim=dataclasses.replace(
            cfg.optim, grad_accum_steps=accum))
        model, state = _torch_state(c, params)
        state, aux = trainer.make_train_step(model, c)(state, batch)
        results.append((state, aux))
    (a, aux_a), (b, aux_b) = results
    np.testing.assert_allclose(aux_a["loss_total"].item(),
                               aux_b["loss_total"].item(), rtol=1e-6)
    np.testing.assert_allclose(aux_a["grad_norm"].item(),
                               aux_b["grad_norm"].item(), rtol=1e-5)
    torch.testing.assert_close(a.params, b.params, rtol=2e-5, atol=1e-7)
    torch.testing.assert_close(a.ema, b.ema, rtol=2e-5, atol=1e-7)
    c3 = dataclasses.replace(cfg, optim=dataclasses.replace(
        cfg.optim, grad_accum_steps=3))
    model, state = _torch_state(c3, params)
    with pytest.raises(ValueError, match="divisible"):
        trainer.make_train_step(model, c3)(state, batch)


@pytest.mark.parametrize("warmup,counts", [
    (0, [0, 1, 199, 200, 201, 399, 400, 1000]),
    (100, [0, 1, 50, 99, 100, 101, 299, 300, 301, 500])])
def test_schedule_matches_optax(warmup, counts):
    cfg = OptimConfig(learning_rate=1e-3, lr_warmup_steps=warmup,
                      lr_decay_steps=200, lr_decay_rate=0.5)
    jcfg = dataclasses.replace(jax_get_config("config3_prf").optim,
                               learning_rate=1e-3, lr_warmup_steps=warmup,
                               lr_decay_steps=200, lr_decay_rate=0.5)
    ours, theirs = make_lr_schedule(cfg), jax_schedule(jcfg)
    for n in counts:
        np.testing.assert_allclose(float(ours(torch.tensor(n))),
                                   float(theirs(jnp.int32(n))), rtol=1e-6,
                                   err_msg=str(n))


def test_overfit_tiny_clip():
    """The mirror of bin_tpu's test_overfit_tiny_clip: one batch, 60 steps
    at lr 2e-3, the loss below half its first value."""
    from bin_tpu_torch.data.pipeline import SyntheticSource, train_iterator

    cfg = get_config("config1_backbone_128", [
        "model.base_features=8", "model.num_res_blocks=1",
        "model.convlstm_features=16", "data.crop_size=32,32",
        "data.batch_size=2", "optim.learning_rate=2e-3"])
    model = build_model(cfg.model, "cpu")
    state = create_train_state(cfg, model)
    it = train_iterator(SyntheticSource(1, 4, 40, 40, seed=3), 2, (32, 32),
                        seed=0, random_flip=False)
    batch = {k: torch.from_numpy(v) for k, v in next(it).items()}
    it.close()
    step = trainer.make_train_step(model, cfg)
    first = None
    for _ in range(60):
        state, aux = step(state, batch)
        if first is None:
            first = aux["loss_total"].item()
    assert aux["loss_total"].item() < 0.5 * first, (first, aux)


# --- checkpoints, export, init, the entry --------------------------------------

def test_checkpoint_round_trip_resumes_bit_for_bit(tmp_path):
    cfg, _ = _cfgs("optim.ema_decay=0.9")
    params = random_flax_params(build_model(cfg.model, "cpu").module, seed=4)
    batches = [{k: torch.from_numpy(v) for k, v in _batch(s).items()}
               for s in range(3)]
    model, state = _torch_state(cfg, params)
    step = trainer.make_train_step(model, cfg)
    for b in batches[:2]:
        state, _ = step(state, b)
    for n in range(1, 4):  # keep_last_n=2 drops the oldest
        ckpt.save(str(tmp_path), n, state, keep_last_n=2)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["2.pt", "3.pt"]
    model2 = build_model(cfg.model, "cpu")
    state2 = ckpt.restore_if_available(str(tmp_path),
                                       create_train_state(cfg, model2, 5))
    assert state2.step == 2
    state, aux = step(state, batches[2])
    state2, aux2 = trainer.make_train_step(model2, cfg)(state2, batches[2])
    for k in ("params", "mu", "nu", "ema", "count"):
        assert torch.equal(getattr(state, k), getattr(state2, k)), k
    assert all(torch.equal(aux[k], aux2[k]) for k in aux)
    restored = flatten(ckpt.restore_params(str(tmp_path)))
    before = flatten(flax_from_params(state2.named(state.params)))
    assert restored.keys() == before.keys()
    ema = flatten(ckpt.restore_params(str(tmp_path), ema=True))
    assert ema.keys() == before.keys()


def test_export_loads_in_bin_tpu_and_the_port(tmp_path):
    cfg, jcfg = _cfgs()
    model = build_model(cfg.model, "cpu")
    tree = model.init(seed=1)
    path = str(tmp_path / "w.npz")
    export_weights(path, tree, cfg.model, {"preset": cfg.preset},
                   store_dtype="float16")
    jparams, jmodel_cfg, meta = jax_load_weights(path)
    params, model_cfg, _ = load_weights(path)
    assert meta["preset"] == "config3_prf"
    for f in dataclasses.fields(model_cfg):
        assert getattr(jmodel_cfg, f.name) == getattr(model_cfg, f.name)
    ours, theirs, src = flatten(params), flatten(jparams), flatten(tree)
    assert ours.keys() == theirs.keys() == src.keys()
    for k in src:
        want = src[k].astype(np.float16).astype(np.float32)
        assert np.array_equal(ours[k], want) and np.array_equal(theirs[k],
                                                                want), k
    np.testing.assert_array_equal(
        flatten(ckpt.restore_params(path))["level_1/head/Conv_0/kernel"],
        ours["level_1/head/Conv_0/kernel"])


def test_init_draws_flax_distributions():
    cfg, _ = _cfgs()
    model = build_model(dataclasses.replace(cfg.model, base_features=32),
                        "cpu")
    tree = flatten(model.init(seed=0))
    assert tree.keys() == flatten(flax_from_params(
        dict(model.module.named_parameters()))).keys()
    for key, v in tree.items():
        if key.endswith("bias") or "/tail/" in key:
            assert not v.any(), key
            continue
        fan_in = v.shape[0] * v.shape[1] * v.shape[2]
        std = np.sqrt(2.0 / fan_in)
        bound = 2 * std / .87962566103423978
        assert np.abs(v).max() <= bound * (1 + 1e-6), key
        if v.size >= 10_000:  # statistics only where they are tight
            assert abs(v.std() / std - 1) < 0.03, (key, v.std(), std)
            assert abs(v.mean()) < 0.03 * std, key
    again = flatten(model.init(seed=0))
    assert all(np.array_equal(again[k], tree[k]) for k in tree)


def test_trainer_entry_on_the_cpu(tmp_path, capsys):
    wd = str(tmp_path / "run")
    trainer.main(["--preset", "config3_prf", "--device", "cpu", "--steps",
                  "2", "--workdir", wd,
                  *sum((["--set", s] for s in TINY), [])])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["step"] == 2 and line["checkpoint"] == 2
    assert line["skipped_steps"] == 0
    with open(f"{wd}/metrics.jsonl") as f:
        rec = [json.loads(x) for x in f]
    assert rec[-1]["step"] == 2 and np.isfinite(rec[-1]["loss_total"])
    # resuming to 3 trains one step more from the checkpoint
    trainer.main(["--device", "cpu", "--steps", "3", "--workdir", wd,
                  *sum((["--set", s] for s in TINY), [])])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])[
        "step"] == 3


def test_trainer_entry_raises_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trainer.main(["--steps", "1", "--workdir", str(tmp_path),
                      *sum((["--set", s] for s in TINY), [])])


@pytest.mark.parametrize("setting,match", [
    ("parallel.spatial_axis_size=2", "spatial"),
    ("model.conv_int8=true", "QAT"),
    ("model.conv_int8_calibrate=true", "calibration")])
def test_unported_training_settings_raise(tmp_path, setting, match):
    if setting.startswith("parallel."):  # --set refuses it already
        cfg = get_config("config3_prf", TINY)
        cfg = dataclasses.replace(cfg, parallel=dataclasses.replace(
            cfg.parallel, spatial_axis_size=2))
    else:
        cfg = get_config("config3_prf", [*TINY, setting])
    assert any(match in s for s in unported_training_fields(cfg))
    with pytest.raises(ValueError, match=match):
        trainer.train(cfg, str(tmp_path), 1, device="cpu")
    # the data axis, the VGG term and config5_v5e_streaming are taken
    assert not unported_training_fields(get_config("config5_v5e_streaming"))
    assert not unported_training_fields(get_config(
        "config3_prf_extended", ["loss.perceptual_mode=vgg"]))


# --- bf16 training --------------------------------------------------------------

# The bf16 step (fp32 master weights, bf16 convs, the ConvLSTM state and the
# loss in fp32) against bin_tpu's on clip_case's clip.  The two frameworks
# round the bf16 convs' sums and bias adds in other places, and bin_tpu on
# the CPU sums a bf16 bias's gradient in bf16, so a bias leaf of small norm
# sits up to ~10 % from the fp32 gradient there.  Measured on this clip:
# the loss 1.07e-5 relative, all gradients 1.98e-2 relative L2, the worst
# kernel leaf 2.9e-2 (level_2/down_1/Conv_0), the worst leaf 0.096
# (level_2/enc_0/Conv_1/bias; 0.163 for a tail bias on another clip); the
# port's bf16 gradient 0.91e-2 from the fp32 one, bin_tpu's 1.88e-2.
BF16_LOSS_RTOL, BF16_GRAD_REL_L2 = 3e-5, 4e-2
BF16_KERNEL_REL_L2, BF16_LEAF_REL_L2 = 6e-2, 0.2


@pytest.fixture(scope="module")
def bf16_case(clip_case):
    """bin_tpu's bf16 loss and gradient of clip_case's clip."""
    cfg, params, batch, _ = clip_case
    _, jcfg = _cfgs("loss.perceptual_weight=0.5", "model.dtype=bfloat16")
    jmodel = jax_build_model(jcfg)
    (loss, _), grads = jax.value_and_grad(
        lambda p: jmodel.loss_clip(p, jnp.asarray(batch["blurry"]),
                                   jnp.asarray(batch["sharp"]), jcfg.loss),
        has_aux=True)(params)
    return float(loss), flatten(jax.device_get(grads))


def test_bf16_loss_and_gradient_match_bin_tpu(clip_case, bf16_case):
    """``model.dtype=bfloat16`` (a case of the refusal test before): the
    loss and the gradient within the measured bounds above; the gradient
    no farther from the fp32 one than bin_tpu's; K1 took bf16 gates and
    an fp32 cell, the parameters and their gradients stayed fp32."""
    cfg, params, batch, (_, _, grads32) = clip_case
    jloss, jgrads = bf16_case
    mcfg = dataclasses.replace(cfg.model, dtype="bfloat16")
    model = build_model(mcfg, "cpu").train_params(params)
    seen = []
    real = lstm_gates.FusedLSTMGates.apply

    def spy(gates, c, bias):
        seen.append((gates.dtype, c.dtype))
        return real(gates, c, bias)

    with mock.patch.object(lstm_gates.FusedLSTMGates, "apply", spy):
        loss, _ = model.loss_clip(torch.from_numpy(batch["blurry"]),
                                  torch.from_numpy(batch["sharp"]), cfg.loss)
    loss.backward()
    assert loss.dtype == torch.float32
    assert seen and set(seen) == {(torch.bfloat16, torch.float32)}
    assert all(p.dtype == p.grad.dtype == torch.float32
               for p in model.module.parameters())
    grads = flatten(flax_from_params(
        {n: p.grad for n, p in model.module.named_parameters()}))
    names = sorted(jgrads)
    cat = lambda g: np.concatenate([g[k].ravel() for k in names])  # noqa: E731
    np.testing.assert_allclose(loss.item(), jloss, rtol=BF16_LOSS_RTOL)
    assert _rel_l2(cat(grads), cat(jgrads)) <= BF16_GRAD_REL_L2
    worst = max((_rel_l2(grads[k], jgrads[k]), k) for k in names)
    assert worst[0] <= BF16_LEAF_REL_L2, worst
    worst = max((_rel_l2(grads[k], jgrads[k]), k) for k in names
                if k.endswith("kernel"))
    assert worst[0] <= BF16_KERNEL_REL_L2, worst
    assert (_rel_l2(cat(grads), cat(grads32))
            <= _rel_l2(cat(jgrads), cat(grads32)))


def test_bf16_train_step_through_the_entry(tmp_path):
    """Two bf16 steps through ``train``, with remat: finite, none skipped,
    the parameters and moments fp32."""
    cfg, _ = _cfgs("model.dtype=bfloat16", "model.remat=true",
                   "optim.ema_decay=0.9")
    _, state = trainer.train(cfg, str(tmp_path), 2, device="cpu")
    assert state.step == 2 and int(state.total_notfinite) == 0
    for buf in (state.params, state.mu, state.nu, state.ema):
        assert buf.dtype == torch.float32 and torch.isfinite(buf).all()


# --- in-training eval, the watchdog, the profiler ------------------------------

EVAL_SETS = ["log.eval_interval_steps=1", "log.eval_clips=2",
             "data.eval_size=32,32", "data.eval_num_keys=6",
             "optim.ema_decay=0.5", "optim.learning_rate=3e-3",
             "log.log_interval_steps=1", "checkpoint.save_interval_steps=100"]


def test_in_training_eval_keeps_the_best_and_leaves_training_alone(
        tmp_path):
    """``log.eval_interval_steps`` (a case of the refusal test before):
    each step's eval is logged; ``best.npz`` is written exactly when the
    PSNR improves, with its card, from the EMA; the steps equal those of a
    run without the eval, bit for bit."""
    cfg, _ = _cfgs(*EVAL_SETS)
    written = []
    real = export_weights

    def spy(path, tree, model_cfg, meta=None, store_dtype=None):
        written.append(meta["step"])
        return real(path, tree, model_cfg, meta, store_dtype)

    wd = tmp_path / "eval"
    with mock.patch("bin_tpu_torch.weights.export_weights", spy):
        model, state = trainer.train(cfg, str(wd), 4, device="cpu")
    with open(wd / "metrics.jsonl") as f:
        evals = [r for r in map(json.loads, f) if "eval_psnr_overall" in r]
    psnr = [r["eval_psnr_overall"] for r in evals]
    assert [r["step"] for r in evals] == [1, 2, 3, 4]
    assert {"eval_ssim_overall", "eval_psnr_interp"} <= set(evals[0])
    improved = [s + 1 for s in range(4) if psnr[s] > max(psnr[:s],
                                                         default=-np.inf)]
    assert written == improved
    card = json.load(open(wd / "best.card.json"))
    meta = card["metadata"]
    best = int(np.argmax(psnr)) + 1
    assert meta["step"] == best and meta["psnr_overall"] == psnr[best - 1]
    assert meta["ema"] is True and meta["eval_clips"] == 2
    assert meta["eval_size"] == [32, 32] and meta["preset"] == "config3_prf"
    assert card["model"]["base_features"] == 8
    # the eval scored the EMA: at the last step, if it was the best, the
    # file holds the final EMA; the parameters stay the training ones
    views = dict(model.module.named_parameters())
    assert all(views[n].data_ptr() == v.data_ptr()
               for n, v in state.named(state.params).items())
    if best == 4:
        tree = flatten(load_weights(str(wd / "best.npz"))[0])
        ema = flatten(flax_from_params(state.named(state.ema)))
        assert all(np.array_equal(tree[k], ema[k]) for k in ema)
    # the same run without the eval: the same state, bit for bit
    plain = dataclasses.replace(cfg, log=dataclasses.replace(
        cfg.log, eval_interval_steps=0))
    _, state2 = trainer.train(plain, str(tmp_path / "plain"), 4,
                              device="cpu")
    for k in ("params", "mu", "nu", "ema", "count"):
        assert torch.equal(getattr(state, k), getattr(state2, k)), k


def test_in_training_eval_scores_the_ema_and_resumes_the_best(tmp_path):
    """One eval by hand: the EMA is scored (the same numbers as an eval of
    the EMA loaded as an inference model), the best file holds it, the
    parameters come back; a resumed run reads the card's PSNR as the
    threshold, and only a better eval overwrites the file."""
    from bin_tpu_torch.evaluation.evaluator import evaluate
    from bin_tpu_torch.data.pipeline import SyntheticSource, eval_clips
    from bin_tpu_torch.utils.logging import MetricLogger

    cfg, _ = _cfgs(*EVAL_SETS)
    params = random_flax_params(build_model(cfg.model, "cpu").module, seed=5)
    model, state = _torch_state(cfg, params)
    state.ema.mul_(0.9)  # an EMA apart from the parameters
    before = state.params.clone()
    logger = MetricLogger(str(tmp_path / "m.jsonl"), stream=None)
    trainer.make_eval_fn(cfg, model, str(tmp_path), logger)(7, state)
    logger.close()
    assert torch.equal(state.params, before)
    rec = json.loads(open(tmp_path / "m.jsonl").read())
    ema_tree = flax_from_params(state.named(state.ema))
    ref = build_model(cfg.model, "cpu").load_params(ema_tree)
    source = SyntheticSource(2, 6, 32, 32, seed=cfg.data.eval_seed,
                             style=cfg.data.synthetic_style)
    want = evaluate(ref, eval_clips(source), verbose=False)
    np.testing.assert_allclose(rec["eval_psnr_overall"],
                               want["psnr_overall"], rtol=1e-6)
    saved = flatten(load_weights(str(tmp_path / "best.npz"))[0])
    assert all(np.array_equal(saved[k], v)
               for k, v in flatten(ema_tree).items())
    # resume: the card's PSNR is the threshold
    score = rec["eval_psnr_overall"]
    for card_psnr, rewritten in ((score + 1.0, False), (score - 1.0, True)):
        meta = {"step": 1, "psnr_overall": card_psnr}
        export_weights(str(tmp_path / "best.npz"), params, cfg.model, meta)
        logger = MetricLogger(None, stream=None)
        trainer.make_eval_fn(cfg, model, str(tmp_path), logger)(8, state)
        card = json.load(open(tmp_path / "best.card.json"))["metadata"]
        assert (card["step"] == 8) is rewritten, card


def test_stall_watchdog_fires_and_the_loop_beats(tmp_path):
    """``log.stall_timeout_s``: without beats the watchdog calls
    ``os._exit(91)`` after the timeout; beaten, it stays quiet; the loop
    beats after each dispatch and each log sync."""
    import threading
    import time

    fired = threading.Event()
    with mock.patch("os._exit", side_effect=lambda code: fired.set()) as ex:
        dog = trainer.StallWatchdog(0.2)
        assert fired.wait(5.0)
        dog.stop()
        ex.assert_called_once_with(trainer.StallWatchdog.EXIT_CODE)
        assert trainer.StallWatchdog.EXIT_CODE == 91
        fired.clear()
        dog = trainer.StallWatchdog(2.0)  # polls every 0.5 s
        for _ in range(24):
            time.sleep(0.05)
            dog.beat()
        dog.stop()
        assert not fired.is_set()

    beats = []

    class Recorder:
        def __init__(self, timeout_s):
            beats.append(("start", timeout_s))

        def beat(self):
            beats.append("beat")

        def stop(self):
            beats.append("stop")

    cfg, _ = _cfgs("log.log_interval_steps=2", "log.stall_timeout_s=5")
    with mock.patch.object(trainer, "StallWatchdog", Recorder):
        trainer.train(cfg, str(tmp_path), 3, device="cpu")
    # 3 dispatches, syncs at steps 2 and 3
    assert beats == [("start", 5.0)] + ["beat"] * 5 + ["stop"]


def test_profiler_traces_steps_10_to_14(tmp_path):
    """``log.profile_dir`` (a case of the refusal test before): a run of
    12 steps traces from step 10 to its end into ``trace.json``."""
    cfg = get_config("config1_backbone_128", [
        "model.base_features=8", "model.num_res_blocks=1",
        "data.crop_size=16,16", "data.batch_size=1",
        f"log.profile_dir={tmp_path / 'prof'}", "log.log_interval_steps=50"])
    started = []
    real = trainer._start_profiler

    def spy(device):
        started.append(device)
        return real(device)

    with mock.patch.object(trainer, "_start_profiler", spy):
        _, state = trainer.train(cfg, str(tmp_path / "run"), 12,
                                 device="cpu")
    assert state.step == 12 and len(started) == 1
    trace = json.load(open(tmp_path / "prof" / "trace.json"))
    names = {e.get("name", "") for e in trace["traceEvents"]}
    assert any("conv" in n for n in names)
