"""Training loop of the port (``bin_tpu/training/trainer.py``), on one card.

    python -m bin_tpu_torch.training.trainer --preset config3_prf \\
        [--set KEY=VALUE ...] [--init-from weights/prf_ema_r4.npz] \\
        [--steps N] [--workdir runs/latest] [--device cuda|cpu]

``bin_tpu`` jits one step (clip scan, loss, gradients, Adam); here a step
runs eagerly: the u8 batch is normalized on the device, the clip loss goes
forward and backward through the pyramid (K2 packs the clip, K1 and K1b
carry the ConvLSTM forward and backward), and the optimizer updates the
flat parameter buffer in place (``state.py``).  Batches come from pinned
host memory with two in flight, and the host waits for the device only at
the log interval and at a checkpoint.  Settings whose code paths are not
ported raise at ``train`` (``config.unported_training_fields``);
``log.stall_timeout_s`` is accepted and ignored.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import time
from typing import Any, Callable, Iterator

import torch

from bin_tpu_torch.config import (Config, get_config,
                                  unported_training_fields)
from bin_tpu_torch.losses import build_perceptual_fn
from bin_tpu_torch.registry import Model, build_model
from bin_tpu_torch.training import checkpoint as ckpt
from bin_tpu_torch.training.state import (TrainState, create_train_state,
                                          make_lr_schedule, optimizer_update,
                                          update_ema, warm_start)
from bin_tpu_torch.utils.logging import MetricLogger

__all__ = ["make_train_step", "device_batches", "train_loop", "train",
           "main"]


def make_train_step(model: Model, cfg: Config) -> Callable:
    """(state, batch) -> (state, aux), updating ``state`` in place.

    batch = {"blurry": (B, K, H, W, 3), "sharp": (B, 2K-1, H, W, 3)} on the
    model's device, uint8 (divided by 255 here) or fp32.  With
    ``optim.grad_accum_steps`` = n > 1 the batch splits into n equal
    microbatches whose gradients are summed and scaled by 1/n, for one
    update (an indivisible batch raises).  aux holds the loss terms and
    ``grad_norm``, the global norm before clipping, as device scalars.
    The step turns grad mode on for itself, whatever the caller's."""
    perceptual_fn = build_perceptual_fn(cfg.loss)
    schedule = make_lr_schedule(cfg.optim)
    accum = max(1, cfg.optim.grad_accum_steps)

    def step(state: TrainState, batch: dict[str, torch.Tensor]):
        batch = {k: (v.float() / 255.0 if v.dtype == torch.uint8 else v)
                 for k, v in batch.items()}
        b = batch["blurry"].shape[0]
        if b % accum:
            raise ValueError(f"batch {b} not divisible by "
                             f"grad_accum_steps={accum}")
        m = b // accum
        state.grads.zero_()
        loss_sum, aux_sum = None, None
        for i in range(accum):
            with torch.enable_grad():
                loss, aux = model.loss_clip(
                    batch["blurry"][i * m:(i + 1) * m],
                    batch["sharp"][i * m:(i + 1) * m], cfg.loss,
                    perceptual_fn)
                loss.backward()
            aux = {k: v.detach() for k, v in aux.items()}
            loss_sum = loss.detach() if loss_sum is None else loss_sum + loss.detach()
            aux_sum = aux if aux_sum is None else {
                k: aux_sum[k] + v for k, v in aux.items()}
        if accum > 1:
            state.grads.mul_(1.0 / accum)
            aux_sum = {k: v * (1.0 / accum) for k, v in aux_sum.items()}
        aux_sum["grad_norm"] = optimizer_update(state, cfg.optim, schedule)
        update_ema(state, cfg.optim.ema_decay)
        state.step += 1
        return state, aux_sum

    return step


def device_batches(batches: Iterator[dict[str, Any]], device: torch.device,
                   size: int = 2) -> Iterator[dict[str, torch.Tensor]]:
    """Copy numpy batches to ``device`` ahead of use, ``size`` in flight:
    on CUDA from pinned memory with ``non_blocking``, so a copy overlaps
    the previous step's work."""
    pin = device.type == "cuda"

    def put(batch):
        out = {}
        for k, v in batch.items():
            t = torch.from_numpy(v)
            out[k] = (t.pin_memory().to(device, non_blocking=True) if pin
                      else t.to(device))
        return out

    queue: collections.deque = collections.deque()
    for batch in batches:
        queue.append(put(batch))
        if len(queue) >= size:
            yield queue.popleft()
    while queue:
        yield queue.popleft()


def train_loop(cfg: Config, model: Model, state: TrainState,
               batches: Iterator[dict[str, Any]], num_steps: int,
               logger: MetricLogger,
               checkpoint_cb: Callable[[int, TrainState], None] | None = None,
               start_step: int = 0) -> TrainState:
    """Run ``num_steps`` steps; ``start_step`` is the restored global step,
    so log and checkpoint indices continue.  The aux values reach the host
    only at the log interval and at the last step."""
    step_fn = make_train_step(model, cfg)
    log_every = max(1, cfg.log.log_interval_steps)
    t_last, frames_since = time.monotonic(), 0
    feed = device_batches(batches, model.device, max(2, cfg.data.prefetch))
    for i in range(num_steps):
        batch = next(feed)
        frames_since += batch["blurry"].shape[0] * batch["blurry"].shape[1]
        state, aux = step_fn(state, batch)
        step_num = start_step + i + 1
        if step_num % log_every == 0 or i + 1 == num_steps:
            aux = {k: float(v) for k, v in aux.items()}  # the host sync
            now = time.monotonic()
            fps = frames_since / max(now - t_last, 1e-9)
            t_last, frames_since = now, 0
            logger.log(step_num, input_fps=fps, **aux)
        if checkpoint_cb is not None:
            checkpoint_cb(step_num, state)
    feed.close()
    return state


def _make_source(cfg: Config):
    """The synthetic training stream of ``bin_tpu``'s ``_make_source``:
    256 cached u8 samples, 16 px of room to crop."""
    from bin_tpu_torch.data.pipeline import SyntheticSource

    ch, cw = cfg.data.crop_size
    return SyntheticSource(num_samples=256, num_keys=cfg.data.seq_len,
                           height=ch + 16, width=cw + 16,
                           taps=cfg.data.blur_taps,
                           stride=cfg.data.blur_stride, seed=cfg.seed,
                           cache=True, as_u8=True,
                           style=cfg.data.synthetic_style)


def train(cfg: Config, workdir: str = "runs/latest",
          num_steps: int | None = None, init_params_from: str = "",
          device: torch.device | str = "cuda") -> tuple[Model, TrainState]:
    """Data, model, checkpoints and loop, in one process on one device.

    ``num_steps`` is the total step target: a run that restores a
    checkpoint from ``workdir`` trains the remainder, on a batch stream
    that starts again from the seed (``bin_tpu``'s thread loader does the
    same).  ``init_params_from`` warm-starts the parameters from a
    checkpoint directory or a released ``.npz``, with a fresh optimizer
    state and the EMA at them.  A checkpoint is written every
    ``checkpoint.save_interval_steps`` and at the last step.  Returns the
    model (in its training form) and the final state."""
    bad = unported_training_fields(cfg)
    if bad:
        raise ValueError("not ported to bin_tpu_torch yet: " + "; ".join(bad))
    from bin_tpu_torch.data.pipeline import train_iterator

    num_steps = num_steps or cfg.optim.num_steps
    os.makedirs(workdir, exist_ok=True)
    logger = MetricLogger(os.path.join(workdir, cfg.log.jsonl_path))
    model = build_model(cfg.model, device)
    state = create_train_state(cfg, model)
    if init_params_from:
        state = warm_start(state, ckpt.restore_params(init_params_from))
    ckpt_dir = os.path.join(workdir, cfg.checkpoint.directory)
    state = ckpt.restore_if_available(ckpt_dir, state)
    start_step = state.step

    def save_cb(step: int, s: TrainState) -> None:
        if step % cfg.checkpoint.save_interval_steps == 0:
            ckpt.save(ckpt_dir, step, s, cfg.checkpoint.keep_last_n)

    remaining = max(0, num_steps - start_step)
    batches = train_iterator(_make_source(cfg), cfg.data.batch_size,
                             cfg.data.crop_size, seed=cfg.seed,
                             random_flip=cfg.data.random_flip,
                             prefetch=cfg.data.prefetch,
                             keep_u8=cfg.data.transfer_u8)
    try:
        state = train_loop(cfg, model, state, batches, remaining, logger,
                           checkpoint_cb=save_cb, start_step=start_step)
    finally:
        batches.close()
        logger.close()
    final = start_step + remaining
    if remaining and final % cfg.checkpoint.save_interval_steps:
        ckpt.save(ckpt_dir, final, state, cfg.checkpoint.keep_last_n)
    return model, state


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(
        description="Train bin_tpu's model with the PyTorch port.")
    ap.add_argument("--preset", default="config3_prf")
    ap.add_argument("--set", action="append", default=[], metavar="KEY=VALUE",
                    help="config override, e.g. model.base_features=8")
    ap.add_argument("--init-from", default="",
                    help="warm start from a checkpoint directory or .npz")
    ap.add_argument("--steps", type=int, default=None,
                    help="total steps (default optim.num_steps)")
    ap.add_argument("--workdir", default="runs/latest")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    cfg = get_config(args.preset, args.set)
    _, state = train(cfg, args.workdir, args.steps, args.init_from,
                     args.device)
    print(json.dumps({"step": state.step, "workdir": args.workdir,
                      "checkpoint": ckpt.latest_step(os.path.join(
                          args.workdir, cfg.checkpoint.directory)),
                      "skipped_steps": int(state.total_notfinite)}))


if __name__ == "__main__":
    main()
