"""Training loop of the port (``bin_tpu/training/trainer.py``).

    python -m bin_tpu_torch.training.trainer --preset config3_prf \\
        [--set KEY=VALUE ...] [--init-from weights/prf_ema_r4.npz] \\
        [--steps N] [--workdir runs/latest] [--device cuda|cpu]

``bin_tpu`` jits one step (clip scan, loss, gradients, Adam); here a step
runs eagerly: the u8 batch is normalized on the device, the clip loss goes
forward and backward through the pyramid (K2 packs the clip, K1 and K1b
carry the ConvLSTM forward and backward), and the optimizer updates the
flat parameter buffer in place (``state.py``).  Batches come from pinned
host memory with two in flight, and the host waits for the device only at
the log interval, at an in-training eval and at a checkpoint.

The data is ``bin_tpu``'s synthetic stream or, with ``data.dataset`` other
than synthetic, the frame-folder tree at ``data.root`` (``data.train_list``
restricting its clips).  ``data.loader=grain`` or ``data.num_workers`` > 0
takes the deterministic loader of ``data/loader.py`` (worker processes),
whose position is saved beside each checkpoint as
``<checkpoint.directory>_loader/<step>.bin``, so a resumed run replays the
batches of an uninterrupted one; otherwise a thread renders the batches,
and a resumed run starts its stream again from the seed.

The parameters stay fp32 (the master weights); ``model.dtype=bfloat16``
runs the convs in bf16 while the ConvLSTM state and the loss stay fp32, as
in ``bin_tpu``.  ``model.conv_int8_qat`` trains the convs the int8 serving
mode takes through ``fake_quant_conv``.  ``log.eval_interval_steps`` scores
the EMA (or the parameters) every so many steps on ``log.eval_clips`` clips
(of the synthetic eval stream, or of the folder tree) and keeps the best as
``<workdir>/best.npz``; ``log.stall_timeout_s`` arms ``StallWatchdog``;
``log.profile_dir`` traces steps 10-14 with ``torch.profiler``;
``log.debug_nans`` raises ``FloatingPointError`` on the first non-finite
loss or gradient, before that step's update.  Settings whose code paths
are not ported raise at ``train`` (``config.unported_training_fields``).

Started by ``torchrun`` (``python -m torch.distributed.run
--nproc_per_node=N``), the run is data-parallel over N ranks, one card
each (``parallel/``): rank r reads only its rows of the one-process batch
(``data.batch_size`` is the global batch), the gradients are averaged
across ranks by one all-reduce of the flat gradient buffer before the
clip, the skip and the EMA, so every rank takes the same update, and rank
0 writes the checkpoints, the loader state, ``metrics.jsonl`` and
``best.npz`` between barriers; every rank restores.
"""

from __future__ import annotations

import collections
import math
import os
import sys
import threading
import time
import warnings
from typing import Any, Callable, Iterator

import torch

from bin_tpu_torch.config import Config, unported_training_fields
from bin_tpu_torch.losses import build_perceptual_fn
from bin_tpu_torch.parallel import (MeshPlan, make_mesh, maybe_initialize,
                                    process_batch_slice)
from bin_tpu_torch.parallel.distributed import local_device
from bin_tpu_torch.registry import Model, build_model
from bin_tpu_torch.training import checkpoint as ckpt
from bin_tpu_torch.training.state import (TrainState, create_train_state,
                                          make_lr_schedule, optimizer_update,
                                          parameters_from, update_ema,
                                          warm_start)
from bin_tpu_torch.utils.logging import MetricLogger

__all__ = ["make_train_step", "device_batches", "StallWatchdog",
           "train_loop", "make_eval_fn", "train", "main"]


def make_train_step(model: Model, cfg: Config,
                    plan: MeshPlan | None = None) -> Callable:
    """(state, batch) -> (state, aux), updating ``state`` in place.

    batch = {"blurry": (B, K, H, W, 3), "sharp": (B, 2K-1, H, W, 3)} on the
    model's device, uint8 (divided by 255 here) or fp32.  With
    ``optim.grad_accum_steps`` = n > 1 the batch splits into n equal
    microbatches whose gradients are summed and scaled by 1/n, for one
    update (an indivisible batch raises).  aux holds the loss terms and
    ``grad_norm``, the global norm before clipping, as device scalars.
    The step turns grad mode on for itself, whatever the caller's.  With
    ``log.debug_nans`` it reads back whether the loss and the gradients
    are finite (its one host sync) and raises ``FloatingPointError``
    naming the step where they are not, before the update: the state
    keeps the previous step's values.

    With a ``plan`` of a process group, ``batch`` is this rank's rows; the
    gradients and the loss terms are averaged across the ranks (one
    all-reduce each) before anything reads them.  DDP is not used: the
    parameters and their ``.grad`` are views into flat buffers
    (``state.py``), which already are the one bucket DDP would copy them
    into, and remat's recomputed forward would meet DDP's hooks."""
    perceptual_fn = build_perceptual_fn(cfg.loss, model.device)
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
        if plan is not None and plan.group:
            plan.mean_(state.grads)
            names = sorted(aux_sum)
            terms = plan.mean_(torch.stack([aux_sum[k].float()
                                            for k in names]))
            aux_sum = dict(zip(names, terms.unbind()))
            loss_sum = aux_sum["loss_total"]
        if cfg.log.debug_nans and not bool(
                torch.isfinite(loss_sum) & torch.isfinite(state.grads).all()):
            raise FloatingPointError(
                f"log.debug_nans: non-finite loss or gradient at step "
                f"{state.step + 1} (loss {loss_sum.item()})")
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


class StallWatchdog:
    """Exit the process when the train loop stops making progress
    (``bin_tpu/training/trainer.py`` ``StallWatchdog``).

    The loop calls ``beat()`` whenever the device demonstrably made
    progress: a step was dispatched, or the host read the metrics back.  A
    daemon thread calls ``os._exit(EXIT_CODE)`` when no beat comes for
    ``timeout_s``: an exit, not an exception, because the main thread is
    then stuck in a blocking call (a hung kernel, a wedged driver) that no
    Python exception interrupts.  The distinct code lets a wrapper retry,
    and resume from the last checkpoint is exact."""

    EXIT_CODE = 91

    def __init__(self, timeout_s: float):
        self.timeout_s = timeout_s
        self._last = time.monotonic()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._watch, daemon=True,
                                        name="stall-watchdog")
        self._thread.start()

    def beat(self) -> None:
        self._last = time.monotonic()

    def stop(self) -> None:
        self._stop.set()

    def _watch(self) -> None:
        while not self._stop.wait(min(30.0, self.timeout_s / 4)):
            idle = time.monotonic() - self._last
            if idle > self.timeout_s:
                print(f"[stall-watchdog] no train-loop progress for "
                      f"{idle:.0f}s (> {self.timeout_s:.0f}s); exiting "
                      f"{self.EXIT_CODE} so a wrapper can retry (resume is "
                      "exact)", file=sys.stderr, flush=True)
                os._exit(self.EXIT_CODE)
                return  # reached only where os._exit is replaced


def _start_profiler(device: torch.device):
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    return prof


def _stop_profiler(prof, directory: str) -> None:
    prof.stop()
    os.makedirs(directory, exist_ok=True)
    prof.export_chrome_trace(os.path.join(directory, "trace.json"))


def train_loop(cfg: Config, model: Model, state: TrainState,
               batches: Iterator[dict[str, Any]], num_steps: int,
               logger: MetricLogger,
               checkpoint_cb: Callable[[int, TrainState], None] | None = None,
               start_step: int = 0, plan: MeshPlan | None = None
               ) -> TrainState:
    """Run ``num_steps`` steps; ``start_step`` is the restored global step,
    so log and checkpoint indices continue.  The aux values reach the host
    only at the log interval and at the last step.  With
    ``log.stall_timeout_s`` > 0 a ``StallWatchdog`` watches the loop; with
    ``log.profile_dir`` the steps 10-14 of this run (fewer in a shorter
    run) are traced into ``<profile_dir>/trace.json``.  ``plan``: the
    data-parallel ranks (``make_train_step``)."""
    step_fn = make_train_step(model, cfg, plan)
    log_every = max(1, cfg.log.log_interval_steps)
    t_last, frames_since = time.monotonic(), 0
    feed = device_batches(batches, model.device, max(2, cfg.data.prefetch))
    watchdog = (StallWatchdog(cfg.log.stall_timeout_s)
                if cfg.log.stall_timeout_s > 0 else None)
    profiler = None
    try:
        for i in range(num_steps):
            if cfg.log.profile_dir and i == 10:
                profiler = _start_profiler(model.device)
            if profiler is not None and i == 15:
                _stop_profiler(profiler, cfg.log.profile_dir)
                profiler = None
            batch = next(feed)
            frames_since += batch["blurry"].shape[0] * batch["blurry"].shape[1]
            state, aux = step_fn(state, batch)
            if watchdog is not None:
                watchdog.beat()  # the step was dispatched
            step_num = start_step + i + 1
            if step_num % log_every == 0 or i + 1 == num_steps:
                aux = {k: float(v) for k, v in aux.items()}  # the host sync
                if watchdog is not None:
                    watchdog.beat()  # the device ran through this step
                now = time.monotonic()
                fps = frames_since / max(now - t_last, 1e-9)
                t_last, frames_since = now, 0
                logger.log(step_num, input_fps=fps, **aux)
            if checkpoint_cb is not None:
                checkpoint_cb(step_num, state)
    finally:
        if profiler is not None:  # a run shorter than 15 steps
            _stop_profiler(profiler, cfg.log.profile_dir)
        if watchdog is not None:
            watchdog.stop()
        feed.close()
    return state


def make_eval_fn(cfg: Config, model: Model, workdir: str,
                 logger: MetricLogger, plan: MeshPlan | None = None
                 ) -> Callable[[int, TrainState], None]:
    """The in-training eval of ``bin_tpu/training/trainer.py:396-476``:
    (step, state) -> None, scoring the first ``log.eval_clips`` clips of
    the synthetic eval stream (``data.eval_seed``, rendered once) or, with
    a folder dataset, of ``data.root`` (``data.eval_list``), at
    ``data.eval_size`` with ``max(data.eval_num_keys, window_size + 2)``
    keys, through the training model, on the EMA when there is one (under
    QAT the fake-quant graph, as
    ``bin_tpu`` scores it).  It logs the ``eval_*`` metrics and writes
    ``<workdir>/best.npz`` with its card only when ``psnr_overall``
    improves on the best so far, which a resumed run reads from the
    existing card.  The training parameters and the optimizer state are
    not touched.  With a ``plan`` of several ranks the clips are dealt
    over them and the result is the one-process result
    (``evaluator.evaluate``); rank 0 writes ``best.npz``."""
    from bin_tpu_torch.data.pipeline import SyntheticSource, eval_clips
    from bin_tpu_torch.evaluation.evaluator import ClipShare, evaluate
    from bin_tpu_torch.weights import (export_weights, flax_from_params,
                                       read_card)

    eh, ew = cfg.data.eval_size
    n_eval = max(1, cfg.log.eval_clips)
    keys = max(cfg.data.eval_num_keys or 0, cfg.model.window_size + 2)
    if cfg.data.dataset == "synthetic" or not cfg.data.root:
        source = SyntheticSource(num_samples=n_eval, num_keys=keys,
                                 height=eh, width=ew, taps=cfg.data.blur_taps,
                                 stride=cfg.data.blur_stride,
                                 seed=cfg.data.eval_seed, cache=True,
                                 style=cfg.data.synthetic_style)
    else:
        from bin_tpu_torch.data.frames import FrameFolderSource
        source = FrameFolderSource(cfg.data.root, num_keys=keys,
                                   resize_to=(eh, ew),
                                   clip_list=cfg.data.eval_list)
    best_path = os.path.join(workdir, "best.npz")
    best = {"psnr": -math.inf}
    if os.path.exists(best_path):
        try:
            best["psnr"] = float(
                read_card(best_path)["metadata"]["psnr_overall"])
        except (OSError, KeyError, TypeError, ValueError):
            pass  # an unreadable card: the next eval overwrites it
    use_ema = cfg.optim.ema_decay > 0
    plan = plan or MeshPlan()
    mine = ClipShare(source, plan, limit=n_eval)

    def eval_fn(step: int, state: TrainState) -> None:
        flat = state.ema if use_ema and state.ema is not None else state.params
        with parameters_from(model, state, flat):
            results = evaluate(model, eval_clips(mine), verbose=False,
                               plan=plan)
        logger.log(step, **{f"eval_{k}": v for k, v in results.items()})
        psnr = results.get("psnr_overall", -math.inf)
        if psnr > best["psnr"]:
            best["psnr"] = psnr
            with plan.main_writes() as main:
                if main:
                    export_weights(
                        best_path, flax_from_params(state.named(flat)),
                        cfg.model,
                        {"step": int(step), "psnr_overall": float(psnr),
                         "preset": cfg.preset, "ema": bool(use_ema),
                         "eval_clips": n_eval, "eval_size": [eh, ew]})

    return eval_fn


def _make_source(cfg: Config):
    """The training source of ``bin_tpu``'s ``_make_source``: 256 cached u8
    synthetic samples with 16 px of room to crop, or the folder tree's
    chunks of ``seq_len`` keys as uint8 frames."""
    if cfg.data.dataset == "synthetic":
        from bin_tpu_torch.data.pipeline import SyntheticSource

        ch, cw = cfg.data.crop_size
        return SyntheticSource(num_samples=256, num_keys=cfg.data.seq_len,
                               height=ch + 16, width=cw + 16,
                               taps=cfg.data.blur_taps,
                               stride=cfg.data.blur_stride, seed=cfg.seed,
                               cache=True, as_u8=True,
                               style=cfg.data.synthetic_style)
    from bin_tpu_torch.data.frames import FrameFolderSource
    return FrameFolderSource(cfg.data.root, num_keys=cfg.data.seq_len,
                             raw_u8=True, clip_list=cfg.data.train_list)


def _loader_batches(cfg: Config, source, loader_dir: str, start_step: int,
                    rows: tuple[int, int]):
    """(batches, state_at, close) of the worker loader making ``rows`` of
    each batch, resumed from ``<loader_dir>/<start_step>.bin``.
    ``state_at(step)`` is the loader's position after the batch of
    ``step``: taken when that batch left the loader, since batches are
    read ahead of the step that consumes them."""
    from bin_tpu_torch.data.loader import WorkerLoader

    loader = WorkerLoader(source, cfg.data.batch_size, cfg.data.crop_size,
                          seed=cfg.seed, random_flip=cfg.data.random_flip,
                          num_workers=cfg.data.num_workers,
                          keep_u8=cfg.data.transfer_u8,
                          prefetch=cfg.data.prefetch, rows=rows)
    if start_step > 0:
        path = os.path.join(loader_dir, f"{start_step}.bin")
        if os.path.exists(path):
            with open(path, "rb") as f:
                loader.set_state(f.read())
        else:
            warnings.warn(
                f"resuming from step {start_step} but no loader state at "
                f"{path}; the batch stream restarts from the beginning and "
                "early batches will be trained on again (exact replay "
                "broken)", stacklevel=3)
    produced: dict[int, bytes] = {}

    def batches():
        for i, batch in enumerate(loader, 1):
            produced[i] = loader.get_state()
            yield batch

    def state_at(step: int) -> bytes:
        idx = step - start_step
        for k in [k for k in produced if k < idx]:
            del produced[k]  # bound memory on long runs
        return produced[idx]

    return batches(), state_at, loader.close


def train(cfg: Config, workdir: str = "runs/latest",
          num_steps: int | None = None, init_params_from: str = "",
          device: torch.device | str = "cuda") -> tuple[Model, TrainState]:
    """Data, model, checkpoints and loop, on one device, or data-parallel
    on one device per rank when the process was started by ``torchrun``
    (``parallel.maybe_initialize``; ``parallel.data_axis_size`` -1 or the
    world size).

    ``num_steps`` is the total step target: a run that restores a
    checkpoint from ``workdir`` trains the remainder, with the worker
    loader from the batch after the checkpoint's, with the thread loader
    on a stream that starts again from the seed (as ``bin_tpu``'s).  ``init_params_from`` warm-starts the parameters from a
    checkpoint directory or a released ``.npz``, with a fresh optimizer
    state and the EMA at them.  A checkpoint (and the worker loader's
    state) is written every ``checkpoint.save_interval_steps`` and at the
    last step; with
    ``log.eval_interval_steps`` the eval of ``make_eval_fn`` runs first at
    those steps.  Returns the model (in its training form) and the final
    state."""
    bad = unported_training_fields(cfg)
    if bad:
        raise ValueError("train does not take: " + "; ".join(bad))
    from bin_tpu_torch.data.pipeline import train_iterator

    source = _make_source(cfg)  # a bad data.root fails before the model
    maybe_initialize(device)
    device = local_device(device)
    plan = make_mesh(cfg.parallel)
    per_rank, first_row = process_batch_slice(cfg.data.batch_size,
                                              plan.rank, plan.num_data)
    rows = (first_row, per_rank)
    num_steps = num_steps or cfg.optim.num_steps
    os.makedirs(workdir, exist_ok=True)
    logger = (MetricLogger(os.path.join(workdir, cfg.log.jsonl_path))
              if plan.is_main else MetricLogger(None, stream=None))
    model = build_model(cfg.model, device)
    state = create_train_state(cfg, model)
    if init_params_from:
        state = warm_start(state, ckpt.restore_params(init_params_from))
    ckpt_dir = os.path.join(workdir, cfg.checkpoint.directory)
    state = ckpt.restore_if_available(ckpt_dir, state)
    start_step = state.step
    eval_fn = (make_eval_fn(cfg, model, workdir, logger, plan)
               if cfg.log.eval_interval_steps > 0 else None)

    state_at = None
    loader_dir = ckpt_dir + "_loader"
    if cfg.data.loader == "grain" or cfg.data.num_workers > 0:
        os.makedirs(loader_dir, exist_ok=True)
        batches, state_at, close_loader = _loader_batches(
            cfg, source, loader_dir, start_step, rows)
    else:
        batches = train_iterator(source, cfg.data.batch_size,
                                 cfg.data.crop_size, seed=cfg.seed,
                                 random_flip=cfg.data.random_flip,
                                 prefetch=cfg.data.prefetch,
                                 keep_u8=cfg.data.transfer_u8, rows=rows)
        close_loader = batches.close

    def save_now(step: int, s: TrainState) -> None:
        with plan.main_writes() as main:
            if main:
                ckpt.save(ckpt_dir, step, s, cfg.checkpoint.keep_last_n)
            if state_at is None:
                return
            loader_state = state_at(step)  # every rank: it frees the older
            if not main:
                return
            with open(os.path.join(loader_dir, f"{step}.bin"), "wb") as f:
                f.write(loader_state)
            kept = sorted(int(n[:-4]) for n in os.listdir(loader_dir)
                          if n.endswith(".bin") and n[:-4].isdigit())
            for old in kept[:-max(1, cfg.checkpoint.keep_last_n)]:
                os.remove(os.path.join(loader_dir, f"{old}.bin"))

    def save_cb(step: int, s: TrainState) -> None:
        if eval_fn is not None and step % cfg.log.eval_interval_steps == 0:
            eval_fn(step, s)
        if step % cfg.checkpoint.save_interval_steps == 0:
            save_now(step, s)

    remaining = max(0, num_steps - start_step)
    try:
        state = train_loop(cfg, model, state, batches, remaining, logger,
                           checkpoint_cb=save_cb, start_step=start_step,
                           plan=plan)
        final = start_step + remaining
        if remaining and final % cfg.checkpoint.save_interval_steps:
            save_now(final, state)
    finally:
        batches.close()
        close_loader()
        logger.close()
    return model, state


def main(argv: list[str] | None = None) -> None:
    """``python -m bin_tpu_torch.cli train`` with config3_prf as the
    default preset."""
    from bin_tpu_torch.cli import train_main

    train_main(["--preset", "config3_prf",
                *(sys.argv[1:] if argv is None else argv)])


if __name__ == "__main__":
    main()
