"""Sample sources and batches, after ``bin_tpu/data/pipeline.py``.

A *source* is any object with:
  __len__() -> int
  __getitem__(i) -> {"blurry": (K, H, W, 3) f32, "sharp": (2K-1, H, W, 3) f32}

``SyntheticSource``, ``eval_clips`` and ``train_iterator`` are copies of
``bin_tpu``'s, so the port scores the same clips and trains on the same
batches for the same seed, byte for byte.  The crop of uint8 samples is
``bin_tpu/data/fastops.py`` ``crop_norm_u8`` in numpy, rounded as its C++
extension (which is not ported) rounds: a multiply by the fp32 1/255.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np

from bin_tpu_torch.data import synthetic

__all__ = ["SyntheticSource", "eval_clips", "train_iterator"]

_INV_255 = np.float32(1.0) / np.float32(255.0)


class SyntheticSource:
    """Procedural source of blurry/sharp samples (see synthetic.py); sample
    ``i`` is rendered from seed ``seed * 1_000_003 + i``.  ``cache`` keeps
    rendered samples in memory after first access; ``as_u8`` quantizes
    them to uint8, as a PNG dataset would be."""

    def __init__(self, num_samples: int, num_keys: int, height: int, width: int,
                 taps: int = 11, stride: int = 8, seed: int = 0,
                 cache: bool = False, as_u8: bool = False,
                 style: str = "smooth"):
        self.num_samples = num_samples
        self.num_keys = num_keys
        self.height = height
        self.width = width
        self.taps = taps
        self.stride = stride
        self.seed = seed
        self.style = style
        self.as_u8 = as_u8
        self._cache: dict[int, dict[str, np.ndarray]] | None = (
            {} if cache else None)

    def __len__(self) -> int:
        return self.num_samples

    def __getstate__(self) -> dict:
        # a loader's worker renders its own samples: no cache is copied
        state = dict(self.__dict__)
        if self._cache is not None:
            state["_cache"] = {}
        return state

    def sample_name(self, i: int) -> str:
        return f"synth{self.seed}_{i:04d}"

    def __getitem__(self, i: int) -> dict[str, np.ndarray]:
        if not 0 <= i < self.num_samples:
            raise IndexError(i)
        if self._cache is not None and i in self._cache:
            return self._cache[i]
        sample = synthetic.make_sample(self.seed * 1_000_003 + i,
                                       self.num_keys, self.height, self.width,
                                       self.taps, self.stride,
                                       style=self.style)
        if self.as_u8:
            sample = {k: (v * 255.0 + 0.5).astype(np.uint8)
                      for k, v in sample.items()}
        if self._cache is not None:
            self._cache[i] = sample
        return sample


def crop_norm_u8(frames: np.ndarray, y0: int, x0: int, ch: int, cw: int,
                 flip_h: bool = False, flip_w: bool = False,
                 flip_t: bool = False) -> np.ndarray:
    """uint8 (T, H, W, 3) -> float32 (T, ch, cw, 3) in [0, 1]: crop, flips,
    normalize.  Multiplies by the fp32 1/255, as ``bin_tpu``'s native
    ``crop_norm_u8``; its numpy fallback divides, one ulp off at times."""
    out = frames[:, y0:y0 + ch, x0:x0 + cw]
    if flip_h:
        out = out[:, ::-1]
    if flip_w:
        out = out[:, :, ::-1]
    if flip_t:
        out = out[::-1]
    return np.ascontiguousarray(out).astype(np.float32) * _INV_255


def _random_crop_flip(sample: dict[str, np.ndarray], crop_hw: tuple[int, int],
                      rng: np.random.Generator, flip: bool,
                      keep_u8: bool = False) -> dict[str, np.ndarray]:
    """One spatial crop and flips shared by the blurry and sharp stacks.

    ``keep_u8``: uint8 crops, normalized on the device by the train step
    (``DataConfig.transfer_u8``).  The draws are the same either way."""
    ch, cw = crop_hw
    h, w = sample["blurry"].shape[1:3]
    if h < ch or w < cw:
        raise ValueError(f"sample {h}x{w} smaller than crop {ch}x{cw}")
    y0 = int(rng.integers(0, h - ch + 1))
    x0 = int(rng.integers(0, w - cw + 1))
    fw = fh = ft = False
    if flip:
        fw = rng.random() < 0.5
        fh = rng.random() < 0.5
        ft = rng.random() < 0.5  # temporal flip: valid, blur is symmetric

    if all(v.dtype == np.uint8 for v in sample.values()) and not keep_u8:
        return {k: crop_norm_u8(v, y0, x0, ch, cw, fh, fw, ft)
                for k, v in sample.items()}
    out = {k: v[:, y0:y0 + ch, x0:x0 + cw] for k, v in sample.items()}
    if fw:
        out = {k: v[:, :, ::-1] for k, v in out.items()}
    if fh:
        out = {k: v[:, ::-1] for k, v in out.items()}
    if ft:
        out = {k: v[::-1] for k, v in out.items()}
    return {k: np.ascontiguousarray(v) for k, v in out.items()}


def train_iterator(source, batch_size: int, crop_size: tuple[int, int],
                   seed: int = 0, random_flip: bool = True,
                   prefetch: int = 2,
                   keep_u8: bool = False) -> Iterator[dict[str, np.ndarray]]:
    """Endless batches {"blurry": (B, K, h, w, 3), "sharp": (B, 2K-1, h, w,
    3)}: samples drawn with ``Philox(seed)``, cropped and flipped on a
    background thread behind a queue of ``prefetch`` batches.  Closing the
    iterator stops the thread."""
    stop = threading.Event()

    def put(q: queue.Queue, item) -> None:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return
            except queue.Full:
                pass

    def produce(q: queue.Queue):
        try:
            rng = np.random.Generator(np.random.Philox(seed))
            n = len(source)
            while not stop.is_set():
                idx = rng.integers(0, n, size=batch_size)
                items = [_random_crop_flip(source[int(i)], crop_size, rng,
                                           random_flip, keep_u8=keep_u8)
                         for i in idx]
                put(q, {k: np.stack([it[k] for it in items])
                        for k in items[0]})
        except BaseException as exc:  # hand it to the consumer, never hang
            put(q, exc)

    q: queue.Queue = queue.Queue(maxsize=max(1, prefetch))
    thread = threading.Thread(target=produce, args=(q,), daemon=True,
                              name="train-iterator")
    thread.start()
    try:
        while True:
            item = q.get()
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
        thread.join(timeout=10)


def eval_clips(source, batch_size: int = 1) -> Iterator[dict[str, np.ndarray]]:
    """Deterministic full-frame eval batches, one pass over the source.

    Samples are grouped by shape before batching (full-clip sources yield
    clips of different lengths); trailing partial batches are padded by
    repeating the last clip of the group with a "valid" mask so metrics can
    ignore padding.  Clip names ride alongside, not stacked."""
    def emit(items: list[tuple[str, dict[str, np.ndarray]]]):
        valid = np.zeros((batch_size,), dtype=bool)
        valid[: len(items)] = True
        items = items + [items[-1]] * (batch_size - len(items))
        batch = {k: np.stack([it[k] for _, it in items]) for k in items[0][1]}
        batch["valid"] = valid
        batch["names"] = [name for name, _ in items]
        return batch

    def name_of(i: int) -> str:
        if hasattr(source, "sample_name"):
            return source.sample_name(i)
        return f"clip{i:04d}"

    buffers: dict[tuple, list] = {}
    for i in range(len(source)):  # single pass; <= batch_size items buffered
        item = source[i]          # per distinct clip shape
        buf = buffers.setdefault(item["blurry"].shape, [])
        buf.append((name_of(i), item))
        if len(buf) == batch_size:
            yield emit(buf)
            buf.clear()
    for buf in buffers.values():
        if buf:
            yield emit(buf)
