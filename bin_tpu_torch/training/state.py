"""Train state and optimizer (``bin_tpu/training/state.py``).

``bin_tpu`` runs optax: ``clip_by_global_norm``, then Adam (AdamW when
``weight_decay > 0``) at a step-decay schedule with an optional linear
warmup, all inside ``apply_if_finite(max_consecutive_errors=100)``, and an
EMA of the parameters beside it.  Here the same arithmetic runs in place on
flat fp32 buffers: the model's parameters and their gradients are views
into ``TrainState.params`` and ``TrainState.grads``, so one update is a
few dozen elementwise passes over the whole model, whatever its number of
tensors.  The decisions that depend on the gradients (the clip, the skip
of a non-finite step) are taken on the device with ``torch.where``, so a
step needs no host sync.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from bin_tpu_torch.config import Config, OptimConfig
from bin_tpu_torch.registry import Model
from bin_tpu_torch.weights import params_from_flax

__all__ = ["TrainState", "make_lr_schedule", "optimizer_update",
           "update_ema", "create_train_state", "warm_start",
           "MAX_CONSECUTIVE_ERRORS"]

MAX_CONSECUTIVE_ERRORS = 100  # optax.apply_if_finite's, as bin_tpu sets it


@dataclasses.dataclass
class TrainState:
    """Everything a step reads and writes.

    ``step`` counts steps taken, skipped ones included; ``count`` counts
    applied updates (Adam's and the schedule's count, which a skipped step
    does not advance), ``notfinite_count``, ``last_finite`` and
    ``total_notfinite`` are ``apply_if_finite``'s state.  ``params``,
    ``grads``, ``mu``, ``nu`` and ``ema`` are flat fp32 buffers laid out by
    ``layout`` ((name, shape, stride, offset) per parameter); ``ema`` is
    None without an EMA."""

    step: int
    layout: list
    params: torch.Tensor
    grads: torch.Tensor
    mu: torch.Tensor
    nu: torch.Tensor
    ema: torch.Tensor | None
    count: torch.Tensor
    notfinite_count: torch.Tensor
    last_finite: torch.Tensor
    total_notfinite: torch.Tensor

    def named(self, flat: torch.Tensor) -> dict[str, torch.Tensor]:
        """Views of one flat buffer by parameter name, shaped and strided
        as the module's parameters."""
        return {name: flat.as_strided(shape, stride, offset)
                for name, shape, stride, offset in self.layout}

    _BUFFERS = ("params", "mu", "nu", "ema")
    _COUNTERS = ("count", "notfinite_count", "last_finite", "total_notfinite")

    def state_dict(self) -> dict:
        """CPU copies: ``step``, the counters, and each buffer as a dict of
        named tensors (None for a missing EMA)."""
        out = {"step": self.step}
        for key in self._COUNTERS:
            out[key] = getattr(self, key).detach().cpu().clone()
        for key in self._BUFFERS:
            flat = getattr(self, key)
            out[key] = (None if flat is None else
                        {n: v.detach().cpu().clone()
                         for n, v in self.named(flat).items()})
        return out

    @torch.no_grad()
    def load_state_dict(self, sd: dict) -> None:
        """Copy ``state_dict()``'s values into this state's buffers (the
        module's parameters stay views of ``params``)."""
        names = [name for name, *_ in self.layout]
        for key in self._BUFFERS:
            flat = getattr(self, key)
            if (flat is None) != (sd[key] is None):
                raise ValueError(f"checkpoint {key}: "
                                 f"{'missing' if sd[key] is None else 'extra'}"
                                 " (optim.ema_decay differs?)")
            if flat is None:
                continue
            if sorted(sd[key]) != sorted(names):
                raise ValueError(f"checkpoint {key} holds other parameters "
                                 "than the model")
            for name, view in self.named(flat).items():
                view.copy_(sd[key][name])
        for key in self._COUNTERS:
            getattr(self, key).copy_(sd[key])
        self.step = int(sd["step"])


def make_lr_schedule(cfg: OptimConfig) -> Callable:
    """count -> learning rate, optax's ``exponential_decay(staircase=True)``
    joined after a linear 0 -> lr warmup of ``lr_warmup_steps``.  Takes an
    int or an integer tensor (on any device) and returns an fp32 tensor."""
    lr = cfg.learning_rate

    def decay(count: torch.Tensor) -> torch.Tensor:
        if cfg.lr_decay_steps <= 0 or cfg.lr_decay_rate == 0:
            return torch.full_like(count, lr)
        p = torch.floor(count / cfg.lr_decay_steps)
        return torch.where(count <= 0, torch.full_like(count, lr),
                           lr * torch.pow(cfg.lr_decay_rate, p))

    def schedule(count) -> torch.Tensor:
        count = torch.as_tensor(count).to(torch.float32)
        if cfg.lr_warmup_steps <= 0:
            return decay(count)
        w = cfg.lr_warmup_steps
        frac = 1 - torch.clamp(count, 0, w) / w
        warm = (0.0 - lr) * frac + lr  # optax.linear_schedule(0, lr, w)
        return torch.where(count < w, warm, decay(count - w))

    return schedule


@torch.no_grad()
def optimizer_update(state: TrainState, cfg: OptimConfig,
                     schedule: Callable) -> torch.Tensor:
    """One optimizer step from ``state.grads``, in place; returns the
    pre-clip global norm (a device scalar).

    optax's order: ``clip_by_global_norm`` (``g`` if its norm is below the
    limit, else ``g / norm * limit``), Adam's moments and bias correction,
    AdamW's decay, ``-lr(count)``, ``params + update``.  With
    ``skip_nonfinite`` a step whose gradients hold a NaN or an Inf leaves
    the parameters, the moments and ``count`` as they were, until more
    than ``MAX_CONSECUTIVE_ERRORS`` such steps come in a row
    (``optax.apply_if_finite``)."""
    g = state.grads
    # summed in fp64: a long fp32 sum of squares drifts (~1e-5 relative
    # at a million elements in torch's CPU vector_norm)
    norm = torch.sum(g * g, dtype=torch.float64).sqrt().float()
    if cfg.grad_clip_norm > 0:
        g = torch.where(norm < cfg.grad_clip_norm, g,
                        (g / norm) * cfg.grad_clip_norm)
    b1, b2 = cfg.beta1, cfg.beta2
    count_inc = state.count + 1
    mu = (1 - b1) * g + b1 * state.mu
    nu = (1 - b2) * (g * g) + b2 * state.nu
    update = ((mu / (1 - torch.pow(b1, count_inc)))
              / (torch.sqrt(nu / (1 - torch.pow(b2, count_inc))) + 1e-8))
    if cfg.weight_decay > 0:
        update = update + cfg.weight_decay * state.params
    params = state.params + (-schedule(state.count)) * update
    if cfg.skip_nonfinite:
        finite = torch.isfinite(state.grads).all()
        bad = torch.where(finite, 0, state.notfinite_count + 1)
        apply = finite | (bad > MAX_CONSECUTIVE_ERRORS)
        state.total_notfinite += (~finite).to(state.total_notfinite.dtype)
        state.notfinite_count.copy_(bad)
        state.last_finite.copy_(finite)
        params = torch.where(apply, params, state.params)
        mu = torch.where(apply, mu, state.mu)
        nu = torch.where(apply, nu, state.nu)
        state.count += apply.to(state.count.dtype)
    else:
        state.count += 1
    state.params.copy_(params)
    state.mu.copy_(mu)
    state.nu.copy_(nu)
    return norm


@torch.no_grad()
def update_ema(state: TrainState, decay: float) -> None:
    """ema = ema * d + params * (1 - d), after every step, skipped or not
    (``bin_tpu/training/trainer.py:95-101``)."""
    if state.ema is not None:
        state.ema.mul_(decay).add_(state.params * (1.0 - decay))


def _bind_flat(model: Model) -> tuple[list, torch.Tensor, torch.Tensor]:
    """Move the module's parameters into one flat fp32 buffer and their
    gradients into another: each parameter (and its ``.grad``) becomes a
    view with the parameter's own shape and strides (channels_last)."""
    params = list(model.module.named_parameters())
    total = sum(p.numel() for _, p in params)
    flat = torch.empty(total, dtype=torch.float32, device=model.device)
    grads = torch.zeros_like(flat)
    layout, offset = [], 0
    for name, p in params:
        if not (p.is_contiguous()
                or p.is_contiguous(memory_format=torch.channels_last)):
            raise ValueError(f"{name}: parameter is not dense")
        view = flat.as_strided(p.shape, p.stride(), offset)
        view.copy_(p.detach())
        p.data = view
        p.grad = grads.as_strided(p.shape, p.stride(), offset)
        layout.append((name, tuple(p.shape), tuple(p.stride()), offset))
        offset += p.numel()
    return layout, flat, grads


def create_train_state(cfg: Config, model: Model,
                       seed: int | None = None) -> TrainState:
    """Fresh parameters (``Model.init(seed)``, ``cfg.seed`` by default) in
    the model's training form, zero moments, the EMA at the parameters."""
    model.train_params(model.init(cfg.seed if seed is None else seed))
    layout, flat, grads = _bind_flat(model)
    dev = model.device

    def scalar(value, dtype=torch.int32):
        return torch.tensor(value, dtype=dtype, device=dev)

    return TrainState(
        step=0, layout=layout, params=flat, grads=grads,
        mu=torch.zeros_like(flat), nu=torch.zeros_like(flat),
        ema=flat.clone() if cfg.optim.ema_decay > 0 else None,
        count=scalar(0), notfinite_count=scalar(0),
        last_finite=scalar(True, torch.bool), total_notfinite=scalar(0))


@torch.no_grad()
def warm_start(state: TrainState, params: dict) -> TrainState:
    """Take a flax parameter tree (``restore_params``) as the parameters,
    with a fresh optimizer state, and re-seat the EMA at them
    (``bin_tpu/training/trainer.py:273-289``)."""
    sd = params_from_flax(params)
    views = state.named(state.params)
    if sorted(sd) != sorted(views):
        raise ValueError("warm start: the parameters do not match the "
                         "model's")
    for name, view in views.items():
        view.copy_(sd[name])
    if state.ema is not None:
        state.ema.copy_(state.params)
    return state

