"""The port's quantization-aware training on the CPU against ``bin_tpu``'s
(``model.conv_int8_qat``): ``fake_quant`` and ``fake_quant_conv`` with
their straight-through gradients, the MSE-clipped weight scales of
``quantize_symmetric``, the conv modes of the model under QAT, the QAT
model's forward, ``loss_clip`` and gradients leaf by leaf, and one and
three QAT train steps.

Tolerances: ``fake_quant`` and the MSE clip bit for bit (the same IEEE
operations); ``fake_quant_conv`` within 1e-5 of ``bin_tpu``'s (which
convolves the dequantized values in fp32, where the port convolves the
integers and scales after) and equal to the port's int8 conv with the
dynamic scale (exact integer sums at these widths); the model as in
``tests/test_torch_training.py``: the loss within 1e-5 relative, each
gradient leaf within 1e-4 relative L2 (measured: 2.2e-6 at worst), the
first step's moves within 1e-3 of the learning rate where the first
gradient is above 1e-5.  Where the parameters or the inputs already differ
by rounding (the forward of a clip, the third step), a quantizer's
round(x / s) flips now and then, as ``bin_tpu``'s does under a 1 + 1e-7
scale of its input: there the bounds are set over what was measured,
stated with them.  Sizes are tiny (base 8, ConvLSTM F=16, 32x32, 5 keys) with
``conv_int8_min_cin`` 16, so that the head, enc_1, down_1, the mids and
dec_1 are QAT convs and the rest stays float.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bin_tpu.config import get_config as jax_get_config
from bin_tpu.ops import quant as jq
from bin_tpu.registry import build_model as jax_build_model
from bin_tpu.training.state import TrainState as JaxTrainState
from bin_tpu.training.state import make_optimizer
from bin_tpu.training.trainer import make_train_step as jax_train_step
from bin_tpu_torch import build_model
from bin_tpu_torch.config import get_config, unported_training_fields
from bin_tpu_torch.models.convlstm import ConvLSTMCell
from bin_tpu_torch.models.layers import Conv, Int8Conv, QATConv, _same_pad
from bin_tpu_torch.ops import quant
from bin_tpu_torch.training import trainer
from bin_tpu_torch.training.state import create_train_state, warm_start
from bin_tpu_torch.weights import flatten, flax_from_params
from torch_params import one_torch_thread  # noqa: F401 (fixture)
from torch_params import random_flax_params

QAT = ["model.base_features=8", "model.num_res_blocks=1",
       "model.convlstm_features=16", "data.crop_size=32,32",
       "data.batch_size=2", "data.seq_len=5", "model.conv_int8_qat=true",
       "model.conv_int8_min_cin=16"]


@pytest.fixture(autouse=True)
def grad_enabled():
    """Grad mode on for each test (``tests/torch_twin.py`` turns it off
    when the suite's workers import it)."""
    with torch.enable_grad():
        yield


def _rel_l2(ours, theirs) -> float:
    ours, theirs = np.asarray(ours, np.float64), np.asarray(theirs, np.float64)
    return float(np.linalg.norm(ours - theirs)
                 / max(np.linalg.norm(theirs), 1e-30))


def _oihw(kernel_hwio: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(kernel_hwio.transpose(3, 2, 0,
                                                                      1)))


# --- the ops ---------------------------------------------------------------

@pytest.mark.parametrize("per_channel", [False, True])
def test_fake_quant_matches_bin_tpu_with_its_gradient(per_channel):
    """Values on .5 steps and a zero channel included; the gradient of a
    weighted sum is the weights (straight through), as ``jax.grad``'s."""
    rng = np.random.default_rng(0)
    k = rng.normal(0, 0.1, (3, 3, 8, 6)).astype(np.float32)
    k[..., 2] = 0.0
    k[0, 0, 0, 3], k[1, 1, 1, 3] = 1.27, 0.025
    cot = rng.normal(0, 1, k.shape).astype(np.float32)
    axis = (0, 1, 2) if per_channel else None
    theirs = jq.fake_quant(jnp.asarray(k), axis=axis)
    jgrad = jax.grad(lambda v: jnp.sum(jq.fake_quant(v, axis=axis)
                                       * cot))(jnp.asarray(k))
    x = _oihw(k).requires_grad_()
    ours = quant.fake_quant(x, dim=(1, 2, 3) if per_channel else None)
    (ours * _oihw(cot)).sum().backward()
    assert np.array_equal(ours.detach().numpy().transpose(2, 3, 1, 0),
                          np.asarray(theirs))
    assert np.array_equal(x.grad.numpy().transpose(2, 3, 1, 0),
                          np.asarray(jgrad))
    # bf16 in, bf16 out, the gradient still straight through
    xb = torch.from_numpy(k).bfloat16().requires_grad_()
    yb = quant.fake_quant(xb)
    yb.float().sum().backward()
    assert yb.dtype == torch.bfloat16 and torch.all(xb.grad == 1)


@pytest.mark.parametrize("stride,hw,cin", [(1, 12, 8), (2, 12, 32),
                                           (2, 11, 16)])
def test_fake_quant_conv_matches_bin_tpu_and_the_int8_conv(stride, hw, cin):
    rng = np.random.default_rng(stride * hw + cin)
    x = rng.uniform(-1, 1, (2, hw, hw, cin)).astype(np.float32)
    k = rng.normal(0, 0.1, (3, 3, cin, 12)).astype(np.float32)
    b = rng.normal(0, 0.01, (12,)).astype(np.float32)
    cot = rng.normal(0, 1, (2, -(-hw // stride), -(-hw // stride), 12)
                     ).astype(np.float32)
    pad = (_same_pad(hw, 3, stride)[0], _same_pad(hw, 3, stride)[0])

    def jfn(a, w, c):
        return jnp.sum(jq.fake_quant_conv(a, w, c, strides=(stride, stride))
                       * cot)

    theirs = jq.fake_quant_conv(jnp.asarray(x), jnp.asarray(k),
                                jnp.asarray(b), strides=(stride, stride))
    jgx, jgk, jgb = jax.grad(jfn, argnums=(0, 1, 2))(
        jnp.asarray(x), jnp.asarray(k), jnp.asarray(b))
    xt = torch.from_numpy(x).requires_grad_()
    kt = _oihw(k).requires_grad_()
    bt = torch.from_numpy(b).requires_grad_()
    ours = quant.fake_quant_conv(xt, kt, bt, stride, pad)
    (ours * torch.from_numpy(cot)).sum().backward()
    assert ours.dtype == torch.float32
    np.testing.assert_allclose(ours.detach().numpy(), np.asarray(theirs),
                               rtol=0, atol=1e-5)
    qw, ks = quant.quantize_weight(_oihw(k))
    with torch.no_grad():
        deployed = quant.int8_conv(torch.from_numpy(x), qw, ks,
                                   torch.from_numpy(b), stride, pad, None)
    assert torch.equal(ours.detach(), deployed)
    for got, want in ((xt.grad.numpy(), jgx),
                      (kt.grad.numpy().transpose(2, 3, 1, 0), jgk),
                      (bt.grad.numpy(), jgb)):
        assert _rel_l2(got, want) <= 1e-6


def test_fake_quant_conv_takes_bf16_and_keeps_the_integer_sums():
    """A bf16 input is quantized from its fp32 value, so the result equals
    the conv of the input taken to fp32; with TF32 off or on the integer
    sums are the same (checked where it matters, on the card, by
    ``chip_smoke.py``)."""
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.uniform(-2, 2, (1, 8, 8, 32)).astype(
        np.float32)).bfloat16()
    w = torch.from_numpy(rng.normal(0, 0.1, (16, 32, 3, 3)).astype(
        np.float32))
    assert torch.equal(quant.fake_quant_conv(x, w, None),
                       quant.fake_quant_conv(x.float(), w, None))


@pytest.mark.parametrize("per_channel", [False, True])
def test_mse_clip_matches_bin_tpu_and_is_never_worse(per_channel):
    """Bit for bit against ``bin_tpu`` on heavy-tailed weights (Student's
    t, 3 degrees of freedom) and on wide uniform ones with one outlier per
    channel; the clipped round trip's squared error never above the
    abs-max one's, per kept channel, and below it on the outliers (where
    clipping pays: 9,216 values per channel gain a finer grid)."""
    axis = (0, 1, 2) if per_channel else None
    dim = (1, 2, 3) if per_channel else None
    cases = [np.random.default_rng(seed).standard_t(3, (3, 3, 16, 24))
             .astype(np.float32) * 0.1 for seed in range(3)]
    wide = np.random.default_rng(5).uniform(-1, 1, (3, 3, 1024, 4)).astype(
        np.float32)
    wide[0, 0, 0, :] = 1.1
    for i, k in enumerate([*cases, wide]):
        jq_, js = jq.quantize_symmetric(jnp.asarray(k), axis=axis,
                                        mse_clip=True)
        w = _oihw(k)
        q, s = quant.quantize_symmetric(w, dim=dim, mse_clip=True)
        assert np.array_equal(q.numpy(), np.asarray(jq_).transpose(3, 2, 0,
                                                                   1))
        assert np.array_equal(s.numpy().reshape(-1),
                              np.asarray(js).reshape(-1))
        q0, s0 = quant.quantize_symmetric(w, dim=dim)
        reduce = dict(dim=dim) if per_channel else {}
        err = ((q.float() * s - w) ** 2).sum(**reduce)
        err0 = ((q0.float() * s0 - w) ** 2).sum(**reduce)
        assert torch.all(err <= err0) and torch.all(s <= s0)
        if k is wide:
            assert torch.all(err < err0), (err, err0)


# --- the model under QAT -----------------------------------------------------

def test_qat_modes_pick_the_convs_bin_tpu_quantizes():
    cfg = get_config("config3_prf", QAT)
    module = build_model(cfg.model, "cpu").module
    qat = {n for n, m in module.named_modules() if isinstance(m, QATConv)}
    want = {f"level_{l}.{b}" for l in (1, 2, 3) for b in (
        "head.Conv_0", "enc_1.Conv_0", "enc_1.Conv_1", "down_1.Conv_0",
        "mid_0.Conv_0", "mid_0.Conv_1", "dec_1.Conv_0", "dec_1.Conv_1")}
    assert qat == want
    # the ConvLSTM gate conv stays float under QAT, as bin_tpu's
    for m in module.modules():
        if isinstance(m, ConvLSTMCell):
            assert type(m.gates) is Conv
    # min_cin 0: every backbone 3x3 conv of _conv3x3_maybe_quant
    every = build_model(dataclasses.replace(cfg.model, conv_int8_min_cin=0),
                        "cpu").module
    assert sum(isinstance(m, QATConv) for m in every.modules()) == 3 * 13
    assert not unported_training_fields(cfg)


def test_the_int8_mode_wins_over_qat_at_build():
    """A QAT card served in the int8 mode (``best.npz`` keeps the flag)
    builds the int8 convs where QAT would have put its own, and no QAT
    conv; training with both flags still refuses the int8 convs."""
    cfg = get_config("config3_prf", QAT)
    both = dataclasses.replace(cfg.model, conv_int8=True)
    model = build_model(both, "cpu")
    assert not model.cfg.conv_int8_qat
    int8 = {n for n, m in model.module.named_modules()
            if isinstance(m, Int8Conv)}
    qat = {n for n, m in build_model(cfg.model, "cpu").module.named_modules()
           if isinstance(m, QATConv)}
    assert int8 == qat
    assert not any(isinstance(m, QATConv) for m in model.module.modules())
    params = random_flax_params(model.module, seed=3)
    with pytest.raises(ValueError, match="model.conv_int8_qat"):
        build_model(both, "cpu").train_params(params)


@pytest.fixture(scope="module")
def qat_case():
    """Random parameters, one clip leaving [-0.8, 1.8] (the clamp acts),
    and bin_tpu's QAT loss and gradient of it."""
    cfg = get_config("config3_prf", QAT)
    jcfg = jax_get_config("config3_prf", QAT)
    params = random_flax_params(build_model(cfg.model, "cpu").module, seed=7)
    rng = np.random.default_rng(1)
    blurry = rng.uniform(-0.8, 1.8, (2, 5, 32, 32, 3)).astype(np.float32)
    sharp = rng.uniform(-0.8, 1.8, (2, 9, 32, 32, 3)).astype(np.float32)
    jmodel = jax_build_model(jcfg)
    (loss, aux), grads = jax.value_and_grad(
        lambda p: jmodel.loss_clip(p, jnp.asarray(blurry),
                                   jnp.asarray(sharp), jcfg.loss),
        has_aux=True)(params)
    return cfg, params, blurry, sharp, (float(loss), jax.device_get(aux),
                                        flatten(jax.device_get(grads)))


def test_qat_loss_clip_and_gradient_match_bin_tpu(qat_case):
    cfg, params, blurry, sharp, (jloss, jaux, jgrads) = qat_case
    model = build_model(cfg.model, "cpu").train_params(params)
    loss, aux = model.loss_clip(torch.from_numpy(blurry),
                                torch.from_numpy(sharp), cfg.loss)
    loss.backward()
    np.testing.assert_allclose(loss.item(), jloss, rtol=1e-5)
    for key in jaux:
        np.testing.assert_allclose(aux[key].item(), float(jaux[key]),
                                   rtol=1e-5, err_msg=key)
    grads = flatten(flax_from_params(
        {n: p.grad for n, p in model.module.named_parameters()}))
    assert sorted(grads) == sorted(jgrads)
    worst = max((_rel_l2(grads[k], jgrads[k]), k) for k in jgrads)
    assert worst[0] <= 1e-4, worst
    # the bound tells QAT from float: the float model's gradient is over it
    plain = build_model(dataclasses.replace(cfg.model, conv_int8_qat=False),
                        "cpu").train_params(params)
    plain.loss_clip(torch.from_numpy(blurry), torch.from_numpy(sharp),
                    cfg.loss)[0].backward()
    pgrads = flatten(flax_from_params(
        {n: p.grad for n, p in plain.module.named_parameters()}))
    assert max(_rel_l2(pgrads[k], jgrads[k]) for k in jgrads) > 1e-4


# The QAT forward of a clip against bin_tpu's: the two convolve the same
# quantized values in other orders (1e-7 apart), and a quantizer's
# round(x / s) then flips for the few activations that sit on a .5 step,
# each flip moving its neighbourhood downstream by about a quantization
# step.  Measured on 6 keys: the port 9.7e-4 from bin_tpu, bin_tpu 6.7e-4
# from itself under a 1 + 1e-7 scale of the clip, and the QAT graph 7.6e-3
# from the float one.
QAT_VIDEO_ATOL = 3e-3


def test_qat_infer_clip_matches_bin_tpu(qat_case):
    """The QAT graph's inference forward (the in-training eval scores it)
    on 6 keys against bin_tpu's, within ``QAT_VIDEO_ATOL``, and farther
    than that from the float graph."""
    cfg, params, blurry, _, _ = qat_case
    clip = np.clip(blurry[:1, :4], 0, 1)
    clip = np.concatenate([clip, clip[:, :2]], axis=1)
    jcfg = jax_get_config("config3_prf", QAT)
    jvideo, jtimes = jax_build_model(jcfg).infer_clip(params,
                                                      jnp.asarray(clip))
    model = build_model(cfg.model, "cpu").train_params(params)
    video, times = model.infer_clip(torch.from_numpy(clip))
    assert list(times) == list(jtimes)
    np.testing.assert_allclose(video.numpy(), np.asarray(jvideo), rtol=0,
                               atol=QAT_VIDEO_ATOL)
    plain, _ = build_model(dataclasses.replace(
        cfg.model, conv_int8_qat=False), "cpu").train_params(
            params).infer_clip(torch.from_numpy(clip))
    assert (plain - video).abs().max().item() > QAT_VIDEO_ATOL


@pytest.fixture(scope="module")
def qat_steps():
    """Three bin_tpu QAT train steps from random parameters (AdamW,
    clipping, EMA) on one batch, as ``test_torch_training``'s step case."""
    sets = [*QAT, "optim.learning_rate=1e-3", "optim.ema_decay=0.9",
            "optim.weight_decay=0.01"]
    cfg, jcfg = get_config("config3_prf", sets), jax_get_config(
        "config3_prf", sets)
    params = random_flax_params(build_model(cfg.model, "cpu").module, seed=9)
    rng = np.random.default_rng(8)
    batch = {"blurry": rng.integers(0, 256, (2, 5, 32, 32, 3), np.uint8),
             "sharp": rng.integers(0, 256, (2, 9, 32, 32, 3), np.uint8)}
    opt = make_optimizer(jcfg.optim)
    p = jax.tree.map(jnp.asarray, params)
    state = JaxTrainState(step=jnp.zeros((), jnp.int32), params=p,
                          opt_state=opt.init(p),
                          ema_params=jax.tree.map(jnp.copy, p))
    step = jax_train_step(jax_build_model(jcfg), jcfg)
    out = []
    for _ in range(3):
        state, aux = step(state, jax.tree.map(jnp.asarray, batch))
        out.append((jax.device_get(state), jax.device_get(aux)))
    return cfg, params, batch, out


# The steps: the first as the fp32 steps of test_torch_training (no
# quantizer flips from the same parameters); after it the parameters differ
# by rounding and the quantizers flip a few activations, so the third is
# held to bounds over what was measured there: loss 2.9e-6 relative, the
# loss terms 6.8e-5, the gradient norm 3.8e-4, moves 0.36 lr, 16 sign
# flips of 119,025 moves.
QAT_STEP3 = {"loss_rtol": 1e-5, "terms_rtol": 2e-4, "grad_norm_rtol": 1e-3,
             "move_atol_lr": 0.5, "flip_share": 1e-3}


def _moves(state, tree, start, grads):
    """The moves from ``start`` of the port's flat buffer and of bin_tpu's
    tree, on the elements whose first gradient is above 1e-5."""
    ours, theirs = flatten(flax_from_params(state.named(tree[0]))), flatten(
        tree[1])
    d_o, d_t = [], []
    for key in theirs:
        mask = np.abs(grads[key]) > 1e-5
        d_o.append((ours[key] - start[key])[mask])
        d_t.append((np.asarray(theirs[key]) - start[key])[mask])
    return np.concatenate(d_o), np.concatenate(d_t)


def test_one_and_three_qat_train_steps_match_bin_tpu(qat_steps):
    cfg, params, batch, jout = qat_steps
    model = build_model(cfg.model, "cpu")
    state = warm_start(create_train_state(cfg, model), params)
    step = trainer.make_train_step(model, cfg)
    start = flatten(params)
    lr = cfg.optim.learning_rate
    grads = None
    for i in range(3):
        state, aux = step(state, {k: torch.from_numpy(v)
                                  for k, v in batch.items()})
        if i == 0:
            grads = flatten(flax_from_params(state.named(state.grads)))
        jstate, jaux = jout[i]
        first = i == 0
        for key in jaux:
            rtol = (1e-5 if first or key == "loss_total" else
                    QAT_STEP3["grad_norm_rtol"] if key == "grad_norm" else
                    QAT_STEP3["terms_rtol"])
            np.testing.assert_allclose(aux[key].item(), float(jaux[key]),
                                       rtol=rtol, err_msg=f"{i + 1} {key}")
        if i == 1:
            continue
        for name, pair in (("params", (state.params, jstate.params)),
                           ("ema", (state.ema, jstate.ema_params))):
            d_o, d_t = _moves(state, pair, start, grads)
            atol = (1e-3 if first else QAT_STEP3["move_atol_lr"]) * lr
            np.testing.assert_allclose(d_o, d_t, rtol=0, atol=atol,
                                       err_msg=f"step {i + 1} {name}")
            flips = int(np.sum(np.sign(d_o) != np.sign(d_t)))
            if name == "params":
                assert flips <= (0 if first else QAT_STEP3["flip_share"]
                                 * d_o.size), (i + 1, flips)
    assert state.step == 3 and int(state.count) == 3


def test_qat_trains_through_the_entry(tmp_path):
    """``train`` takes QAT with min_cin (a case of the refusal test
    before), in bf16 with remat and the EMA, as tools/qat_finetune.sh
    sets it: two steps, finite, none skipped."""
    cfg = get_config("config3_prf", [*QAT, "model.dtype=bfloat16",
                                     "model.remat=true",
                                     "optim.ema_decay=0.999",
                                     "optim.learning_rate=1e-5",
                                     "log.log_interval_steps=1"])
    model, state = trainer.train(cfg, str(tmp_path), 2, device="cpu")
    assert state.step == 2 and int(state.total_notfinite) == 0
    assert any(isinstance(m, QATConv) for m in model.module.modules())
    assert torch.isfinite(state.params).all() and torch.isfinite(
        state.ema).all()
