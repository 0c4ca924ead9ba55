"""Streaming inference session: constant-latency joint deblur + 2x interp
over an unbounded video stream (``bin_tpu/evaluation/streaming.py``).

``Model.infer_clip`` scans a finite clip; serving needs the other shape:
key frames arrive one at a time, and after each arrival the session emits
the newly determined output frames, with the ConvLSTM carries held on the
device between calls.

Per key-frame arrival (after the first window fills):
  ingest  = pack the key (K2), normalise a u8 key after the pack
  window  = last ``window_size`` keys, shifted in on the device
  pyramid forward of the window, the carries updated
  emits   = [2nd deblurred key (level 2), centre midpoint (deepest level)]
i.e. 2 output frames per input key, exactly 2x rate, with a fixed latency
of window_size-2 key intervals.  The first window also emits its leading
frames (times 1..K-3 on the 2x grid); ``flush`` emits the last window's
trailing ones.  The emissions are ``infer_clip``'s frames at the same
times: the same plan picks the same level and window for each.

Batch axis = independent streams.  Inference mode is entered inside the
methods: grad mode is thread-local, and a server calls them from its
handler threads.

With a ``plan`` (``parallel.MeshPlan``) the session is one rank of a mesh,
as ``bin_tpu``'s session over a device mesh: the streams are dealt over
the data axis (``batch % num_data`` must be 0) and each frame's height
over the spatial axis (``Model.shard_height``: a band of whole blocks per
rank, halo rows exchanged in every row-crossing conv).  Every rank is
pushed the whole batch's keys and keeps its streams and rows; every
emission is gathered from all ranks, so ``push``, ``poll`` and ``drain``
return the whole batch's whole frames on every rank, as ``bin_tpu``'s
single controller does.  All ranks make the same calls in the same order.
"""

from __future__ import annotations

import queue
import threading

import numpy as np
import torch

from bin_tpu_torch.config import ModelConfig
from bin_tpu_torch.models.pyramid import level_output_times, total_levels
from bin_tpu_torch.ops.pixel_shuffle import depth_to_space, space_to_depth
from bin_tpu_torch.parallel.spatial import gather_world
from bin_tpu_torch.registry import Model

__all__ = ["StreamingSession"]


def _deepest(cfg: ModelConfig, t: int) -> tuple[int, int, int] | None:
    """(level_idx, pair_idx, t) of the deepest level predicting local time
    ``t``, or None (e.g. even times in an interp-only 1-level model)."""
    for li in range(total_levels(cfg) - 1, -1, -1):
        times = level_output_times(li + 1, cfg.window_size)
        if t in times:
            return li, times.index(t), t
    return None


def _emit_plan(cfg: ModelConfig,
               first_window: bool) -> list[tuple[int, int, int]]:
    """(level_idx, pair_idx, local_time) to emit for this window.

    Steady state emits local times {K-2, K-1}: one deblurred key and one
    midpoint per arriving key, each from the deepest level predicting that
    parity and from the latest window containing it.  Consecutive windows
    advance by 2 on the output grid, so emissions are contiguous and in
    order; the first full window back-fills times 1..K-3."""
    k = cfg.window_size
    ts = list(range(1, k - 2)) if first_window else []
    plan = [_deepest(cfg, t) for t in ts + [k - 2, k - 1]]
    return [p for p in plan if p is not None]


def _flush_plan(cfg: ModelConfig) -> list[tuple[int, int, int]]:
    """The last window's trailing times (local K..2K-3), which steady state
    deferred to windows that will never arrive."""
    k = cfg.window_size
    plan = [_deepest(cfg, t) for t in range(k, 2 * (k - 1))]
    return [p for p in plan if p is not None]


class StreamingSession:
    """Streaming joint deblur + 2x interp with device-resident emissions.

    ``push`` returns (time, frame) pairs whose frames are unpacked fp32
    tensors still on the device (interactive mode); ``buffer_drain``,
    ``emit_u8`` and ``async_drain`` select the serving modes below."""

    def __init__(self, model: Model, batch: int, height: int, width: int,
                 buffer_drain: bool = False, emit_u8: bool = False,
                 async_drain: bool = False, plan=None):
        """``buffer_drain``: keep emissions on the device for one stacked
        device->host copy per ``drain()``; push() then returns [].

        ``emit_u8``: drained frames are quantized to uint8 on the device, in
        the packed domain, then unpacked: 4x less device->host traffic.

        ``async_drain``: per-key delivery without the copy on the critical
        path.  Each window's emissions are finalized (unpacked, u8 with
        ``emit_u8``) and copied on a side CUDA stream into pinned host
        memory; a background thread waits for each copy and hands the
        frames to ``poll()`` (non-blocking) and ``drain()`` (blocks for the
        copies in flight).  push() returns [].  Call ``close()`` to stop
        the thread.

        ``plan``: this rank's place in a mesh (module docstring).  A plan
        with a spatial axis binds ``model`` to it (``shard_height``); a
        model bound to a spatial axis needs its plan."""
        f = model.cfg.stem_factor
        if plan is not None:
            if batch % plan.num_data:
                raise ValueError(f"batch {batch} streams must divide over "
                                 f"data={plan.num_data} mesh axis")
            if plan.num_spatial > 1:
                if (height // f) % plan.num_spatial:
                    raise ValueError(
                        f"packed height {height}//{f} must divide over "
                        f"spatial={plan.num_spatial} mesh axis")
                if model.plan is not plan:
                    model.shard_height(plan)
        if model.plan is not None and model.plan is not plan:
            raise ValueError("the model is bound to a spatial axis "
                             "(Model.shard_height): pass its plan")
        self.plan = plan
        self._band = model.band(height)  # raises where the height won't cut
        self._rows = [n for _, n in model.bands(height)]
        self._local = batch // (1 if plan is None else plan.num_data)
        self._first = 0 if plan is None else plan.data_index * self._local
        self.model = model
        self.k = model.cfg.window_size
        self.batch, self.height, self.width = batch, height, width
        self.buffer_drain = buffer_drain
        self.emit_u8 = emit_u8
        self.async_drain = async_drain
        self._plans = {first: _emit_plan(model.cfg, first)
                       for first in (True, False)}
        self._flush_plan = _flush_plan(model.cfg)
        self._stack_shape = (self._local, self.k, self._band[1] // f,
                             width // f, 3 * f * f)

        if async_drain:
            # Depth 2: one window in compute, one emission in device->host
            # flight; a full queue makes push() wait about one window (the
            # backpressure that bounds a stream's latency).
            self._fetch_q: queue.Queue = queue.Queue(maxsize=2)
            self._ready: list[tuple[int, np.ndarray]] = []
            self._ready_lock = threading.Lock()
            self._fetch_error: BaseException | None = None
            self._copy_stream = (torch.cuda.Stream(model.device)
                                 if model.device.type == "cuda" else None)
            self._fetcher = threading.Thread(
                target=self._fetch_loop, daemon=True,
                name="bin-tpu-torch-stream-fetch")
            self._fetcher.start()
        self.reset()

    # -- state ------------------------------------------------------------
    def reset(self) -> None:
        """New stream(s): clear ConvLSTM carries and the frame window."""
        with torch.inference_mode():
            self.states = self.model.initial_state(self._local, self.height,
                                                   self.width)
            self._stack = torch.zeros(self._stack_shape,
                                      dtype=self.model.dtype,
                                      device=self.model.device)
        self._keys_seen = 0
        self._last_outputs = None
        self._last_start_t = 0
        # pending emissions: (times, (E, B, h, w, C) packed device tensor)
        self._pending: list[tuple[list[int], torch.Tensor]] = []
        if self.async_drain:
            self._fetch_q.join()  # let in-flight fetches land, then discard
            with self._ready_lock:
                self._ready.clear()

    def close(self) -> None:
        """Stop the async fetch thread.  The thread holds the session, so
        a long-running owner (the serving daemon) closes the sessions it
        retires."""
        if self.async_drain and self._fetcher.is_alive():
            self._fetch_q.put(None)
            self._fetcher.join(timeout=60)

    # -- delivery ---------------------------------------------------------
    def _fetch_loop(self) -> None:
        while True:
            item = self._fetch_q.get()
            if item is None:  # close() sentinel
                self._fetch_q.task_done()
                return
            times, frames, copied = item
            try:
                if copied is not None:
                    copied.synchronize()
                host = frames.numpy()  # (E, B, H, W, 3), host memory
                with self._ready_lock:
                    self._ready.extend(zip(times, host))
            except Exception as exc:  # raised again by poll() and drain()
                self._fetch_error = exc
            finally:
                self._fetch_q.task_done()

    def _enqueue(self, times: list[int], frames: torch.Tensor) -> None:
        """Hand finalized frames to the fetch thread: on the card, after a
        copy into pinned memory on the side stream, ordered after the
        compute stream's work so far."""
        if self._copy_stream is None:
            self._fetch_q.put((times, frames, None))
            return
        host = torch.empty(frames.shape, dtype=frames.dtype, pin_memory=True)
        self._copy_stream.wait_stream(torch.cuda.current_stream(frames.device))
        with torch.cuda.stream(self._copy_stream):
            host.copy_(frames, non_blocking=True)
            copied = torch.cuda.Event()
            copied.record(self._copy_stream)
        # the allocator must not hand ``frames``' memory to the next key's
        # work on the compute stream while the side stream still reads it
        frames.record_stream(self._copy_stream)
        self._fetch_q.put((times, host, copied))

    def poll(self) -> list[tuple[int, np.ndarray]]:
        """Async mode: frames whose device->host copy has completed,
        non-blocking, in time order.  Empty in other modes (use drain)."""
        if not self.async_drain:
            return []
        if self._fetch_error is not None:
            raise RuntimeError("streaming fetch failed") from self._fetch_error
        with self._ready_lock:
            out, self._ready = self._ready, []
        return sorted(out, key=lambda tf: tf[0])

    def drain(self) -> list[tuple[int, np.ndarray]]:
        """Every pending emission as (time, (B, H, W, 3) numpy) pairs in time
        order: fp32 in [0, 1], or uint8 with ``emit_u8``.

        buffer mode: one stacked device->host copy of everything pending.
        async mode: wait for the copies in flight, then hand over whatever
        poll() has not returned yet."""
        if self.async_drain:
            self._fetch_q.join()
            return self.poll()
        if not self._pending:
            return []
        times = [t for ts, _ in self._pending for t in ts]
        with torch.inference_mode():
            stacked = self._gather(self._finalize(
                torch.cat([e for _, e in self._pending], dim=0)))
            self._pending = []
            host = stacked.cpu().numpy()
        return sorted(zip(times, host), key=lambda tf: tf[0])

    # -- compute ----------------------------------------------------------
    def _gather(self, frames: torch.Tensor) -> torch.Tensor:
        """(E, b, h, W, 3) frames of this rank's streams and band -> the
        whole batch's whole frames, from every rank of the plan."""
        if self.plan is None:
            return frames
        return gather_world(self.plan, frames, self._rows, row_dim=2,
                            batch_dim=1)

    def _ingest(self, frames) -> torch.Tensor:
        """(B, H, W, 3) key frames -> packed (B, h, w, 3f^2) in the compute
        dtype.  A u8 key is packed first (K2 on a quarter of the bytes of
        fp32) and normalised after; a float key is cast, then packed: the
        pack is a permutation, so either order gives the same bits as
        ``infer_clip``'s cast-then-pack of ``u8 / 255``."""
        if isinstance(frames, np.ndarray):
            # a read-only buffer (an HTTP body) is copied; torch wants to
            # own writable memory
            frames = torch.from_numpy(frames if frames.flags.writeable
                                      else frames.copy())
        start, rows = self._band
        x = frames[self._first:self._first + self._local,
                   start:start + rows].to(self.model.device)
        f = self.model.cfg.stem_factor
        if x.dtype == torch.uint8:
            packed = space_to_depth(x.contiguous(), f)
            return (packed.float() / 255.0).to(self.model.dtype)
        return space_to_depth(x.to(self.model.dtype).contiguous(), f)

    def _finalize(self, emitted: torch.Tensor) -> torch.Tensor:
        """Packed stacked emissions -> delivery format (fp32 or u8).  u8 is
        quantized in the packed domain and the uint8 tensor unpacked: the
        unpack is a permutation, so it commutes with the pointwise
        clip/scale/round, and it moves a quarter of the bytes."""
        f = self.model.cfg.stem_factor
        if self.emit_u8:
            q = torch.round(emitted.float().clamp(0.0, 1.0) * 255.0)
            return depth_to_space(q.to(torch.uint8), f)
        return depth_to_space(emitted.float(), f)

    def _emit(self, times: list[int], emitted: torch.Tensor) -> list:
        if self.async_drain:
            self._enqueue(times, self._gather(self._finalize(emitted)))
            return []
        if self.buffer_drain:
            self._pending.append((times, emitted))
            return []
        frames = self._gather(depth_to_space(emitted.float(),
                                             self.model.cfg.stem_factor))
        return [(t, frames[i]) for i, t in enumerate(times)]

    def push(self, key_frames) -> list[tuple[int, torch.Tensor]]:
        """Feed one blurry key frame per stream: (B, H, W, 3), numpy or a
        tensor, float in [0, 1] or uint8 (normalized on the device).

        Returns a list of (global_output_time, (B, H, W, 3) fp32 sharp frame
        on the device), empty until the first window fills, and always
        empty in the ``buffer_drain`` and ``async_drain`` modes."""
        if tuple(key_frames.shape) != (self.batch, self.height, self.width, 3):
            raise ValueError(f"expected {(self.batch, self.height, self.width, 3)},"
                             f" got {tuple(key_frames.shape)}")
        with torch.inference_mode():
            packed = self._ingest(key_frames)
            self._stack = torch.cat([self._stack[:, 1:], packed[:, None]],
                                    dim=1)
            self._keys_seen += 1
            if self._keys_seen < self.k:
                return []
            first = self._keys_seen == self.k
            outputs, self.states = self.model.module(self._stack, self.states)
            start = 2 * (self._keys_seen - self.k)
            self._last_outputs, self._last_start_t = outputs, start
            plan = self._plans[first]
            emitted = torch.stack([outputs[li][:, j] for li, j, _ in plan])
            return self._emit([start + t for _, _, t in plan], emitted)

    def flush(self) -> list[tuple[int, torch.Tensor]]:
        """End of stream: emit the trailing times (local K..2K-3) of the
        last computed window.  Returns as push() does."""
        outputs, self._last_outputs = self._last_outputs, None
        plan = self._flush_plan
        if outputs is None or not plan:
            return []
        with torch.inference_mode():
            frames = torch.stack([outputs[li][:, j] for li, j, _ in plan])
            return self._emit([self._last_start_t + t for _, _, t in plan],
                              frames)
