"""The deterministic, resumable training loader, in worker processes: the
counterpart of ``bin_tpu/data/grain_pipeline.py`` ``grain_train_iterator``
without ``grain``.

It yields the batches that ``bin_tpu``'s grain loader yields in one process
for the same source, seed, batch and crop.  Epoch ``e`` visits the records
in the order of grain's ``index_shuffle`` (a Simon cipher on the index,
keyed by ``std::seed_seq(seed + e)``, walked until it lands in range),
which ``index_shuffle`` below computes in numpy; the record at stream
position ``j`` is cropped and flipped by ``_random_crop_flip`` with
``np.random.Generator(np.random.Philox(key=seed + j))``, as grain's
``IndexSampler`` seeds it.  Batch ``k`` is the records ``k*B .. k*B+B-1``.

With ``num_workers`` > 0, worker ``w`` of ``W`` makes the batches ``k`` with
``k % W == w`` and the loader hands them out in order, so the batches for
a (seed, step) are the same whatever ``num_workers`` is (grain's workers
each batch their own records, so its batches change with the count; its
``worker_count=0`` stream is the one matched here).  The workers are
``spawn``ed, never forked: the caller may hold a CUDA context.  The source
goes to them pickled.  ``get_state()`` after a batch and ``set_state()``
on a new loader resume the stream exactly after it.
"""

from __future__ import annotations

import json
import math
import multiprocessing
import queue
import traceback
import weakref
from typing import Iterator

import numpy as np

from bin_tpu_torch.data.pipeline import _random_crop_flip

__all__ = ["index_shuffle", "WorkerLoader"]

_M32 = 0xFFFFFFFF


def _seed_seq(seed: int, n: int) -> list[int]:
    """``std::seed_seq{seed}.generate`` of ``n`` words (the C++ standard's
    algorithm), the round keys of grain's ``index_shuffle``."""
    v, s = [seed & _M32], 1
    b = [0x8B8B8B8B] * n
    t = (11 if n >= 623 else 7 if n >= 68 else 5 if n >= 39
         else 3 if n >= 7 else (n - 1) // 2)
    p, q = (n - t) // 2, (n - t) // 2 + t

    def tmix(x: int) -> int:
        return x ^ (x >> 27)

    m = max(s + 1, n)
    for k in range(m):
        r1 = 1664525 * tmix(b[k % n] ^ b[(k + p) % n] ^ b[(k - 1) % n]) & _M32
        r2 = (r1 + (s if k == 0 else k % n + v[k - 1] if k <= s else k % n)
              ) & _M32
        b[(k + p) % n] = (b[(k + p) % n] + r1) & _M32
        b[(k + q) % n] = (b[(k + q) % n] + r2) & _M32
        b[k % n] = r2
    for k in range(m, m + n):
        r3 = 1566083941 * tmix(
            (b[k % n] + b[(k + p) % n] + b[(k - 1) % n]) & _M32) & _M32
        r4 = (r3 - k % n) & _M32
        b[(k + p) % n] ^= r3
        b[(k + q) % n] ^= r4
        b[k % n] = r4
    return b


def index_shuffle(index, max_index: int, seed: int,
                  rounds: int = 4) -> np.ndarray:
    """Where ``index`` lands in grain's pseudorandom permutation of
    ``[0, max_index]`` (``grain/_src/python/experimental/index_shuffle``):
    a Simon cipher on blocks of max(16, ceil(log2(max_index)) rounded up
    to even) bits, two rounds per key pair, repeated until the block is at
    most ``max_index``.  ``index`` is an int or an array of them.  Blocks
    of up to 20 bits are all enciphered at once: for a short epoch the
    walk would take thousands of steps.  As in grain, an index past the
    block (max_index = 2^bits exactly) wraps, so such an epoch is not a
    permutation."""
    index = np.asarray(index, dtype=np.uint64)
    if max_index == 0:
        return np.zeros_like(index)
    bits = math.ceil(math.log2(float(max_index)))
    bits = max(bits + bits % 2, 16)
    half = np.uint64(bits // 2)
    mask = np.uint64((1 << (bits // 2)) - 1)
    keys = [np.uint64(k) & mask for k in _seed_seq(seed, rounds)]

    def rotl(y, r):
        return ((y << np.uint64(r)) | (y >> (half - np.uint64(r)))) & mask

    def f(y):
        return (rotl(y, 1) & rotl(y, 8)) ^ rotl(y, 2)

    def encrypt(block):
        x, y = (block >> half) & mask, block & mask
        for i in range(0, rounds, 2):
            x = x ^ f(y) ^ keys[i]
            y = y ^ f(x) ^ keys[i + 1]
        return (x << half) | y

    top = np.uint64(max_index)
    if bits > 20:  # at least a quarter of the blocks are in range
        out = encrypt(index)
        while (todo := out > top).any():
            out[todo] = encrypt(out[todo])
        return out
    # every block's image, then pointer doubling: hop[b] stays on b's
    # orbit at or before the first block in range after b, and doubles its
    # reach each pass until every block in range points into range
    hop = encrypt(np.arange(1 << bits, dtype=np.uint64))
    while (far := hop > top)[:max_index + 1].any():
        hop[far] = hop[hop[far]]
    return hop[index & np.uint64((1 << bits) - 1)]


class _Stream:
    """The records of each batch: position ``j`` of this shard's stream
    reads record ``start + perm_e(j % L)`` (epoch e = j // L, L the shard's
    length) and crops it with ``Philox(key=seed + j * count + index)``."""

    def __init__(self, source, batch_size: int, crop_size, seed: int,
                 random_flip: bool, keep_u8: bool, shard_index: int,
                 shard_count: int, num_epochs: int | None):
        self.source = source
        self.batch_size = batch_size
        self.crop_size = tuple(crop_size)
        self.seed = seed
        self.random_flip = random_flip
        self.keep_u8 = keep_u8
        self.shard_index, self.shard_count = shard_index, shard_count
        self.length = len(source) // shard_count  # the remainder is dropped
        if self.length == 0:
            raise ValueError(f"{len(source)} records for {shard_count} shards")
        self.start = self.length * shard_index
        self.num_batches = (None if num_epochs is None else
                            num_epochs * self.length // batch_size)
        self._perm: tuple[int, np.ndarray] | None = None

    def record(self, j: int):
        epoch, pos = divmod(j, self.length)
        if self._perm is None or self._perm[0] != epoch:
            self._perm = (epoch, index_shuffle(
                np.arange(self.length), self.length - 1,
                (self.seed + epoch) & _M32))
        key = self.start + int(self._perm[1][pos])
        rng = np.random.Generator(np.random.Philox(
            key=self.seed + j * self.shard_count + self.shard_index))
        return _random_crop_flip(self.source[key], self.crop_size, rng,
                                 self.random_flip, keep_u8=self.keep_u8)

    def batch(self, k: int) -> dict[str, np.ndarray]:
        items = [self.record(j) for j in range(k * self.batch_size,
                                               (k + 1) * self.batch_size)]
        return {name: np.stack([it[name] for it in items])
                for name in items[0]}


def _put(out, item, stop) -> bool:
    while not stop.is_set():
        try:
            out.put(item, timeout=0.1)
            return True
        except queue.Full:
            pass
    return False


def _worker(stream: _Stream, first: int, step: int, out, stop) -> None:
    """Make batches first, first + step, ... into ``out`` until ``stop``
    or the stream's end."""
    k = first
    try:
        while not stop.is_set() and (stream.num_batches is None
                                     or k < stream.num_batches):
            if not _put(out, ("batch", k, stream.batch(k)), stop):
                break
            k += step
    except Exception:  # hand it to the loader, never hang it
        _put(out, ("error", k, traceback.format_exc()), stop)
    if stop.is_set():
        out.cancel_join_thread()  # exit without flushing unread batches


def _shutdown(procs: list, queues: list, stop) -> None:
    stop.set()
    for q in queues:  # a worker that has finished waits until its batches
        try:          # are read: drain before joining
            while True:
                q.get_nowait()
        except (queue.Empty, OSError, EOFError, ValueError):
            pass
    for p in procs:
        p.join(timeout=10)
        if p.is_alive():
            p.terminate()
            p.join(timeout=10)
    for q in queues:
        q.close()


class WorkerLoader:
    """Endless (or ``num_epochs``) batches {"blurry": (B, K, h, w, 3),
    "sharp": (B, 2K-1, h, w, 3)}, as ``grain_train_iterator`` yields them
    (``keep_u8``: uint8 crops; ``shard_index``/``shard_count``: this
    process's disjoint part of the records, the remainder dropped).

    ``num_workers=0`` makes each batch in this process when it is asked
    for; otherwise ``spawn``ed workers make them ahead, ``prefetch`` each,
    and a batch that takes longer than ``timeout_s`` to arrive raises, as
    does a worker's error or death.  ``close()`` (also on error, at garbage
    collection and at exit) stops the workers."""

    def __init__(self, source, batch_size: int, crop_size, seed: int = 0,
                 random_flip: bool = True, num_workers: int = 0,
                 num_epochs: int | None = None, keep_u8: bool = False,
                 shard_index: int | None = None,
                 shard_count: int | None = None, prefetch: int = 2,
                 timeout_s: float = 600.0):
        count = shard_count or 1
        self._stream = _Stream(source, batch_size, crop_size, seed,
                               random_flip, keep_u8, shard_index or 0, count,
                               num_epochs)
        self.num_workers = num_workers
        self.prefetch = max(1, prefetch)
        self.timeout_s = timeout_s
        self._next = 0
        self._first = 0
        self._procs: list = []
        self._queues: list = []
        self._finalize = None

    def __iter__(self) -> Iterator[dict[str, np.ndarray]]:
        return self

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def _identity(self) -> dict:
        s = self._stream
        return {"num_records": len(s.source), "batch_size": s.batch_size,
                "crop_size": list(s.crop_size), "seed": s.seed,
                "random_flip": s.random_flip, "keep_u8": s.keep_u8,
                "shard_index": s.shard_index, "shard_count": s.shard_count}

    def get_state(self) -> bytes:
        """The position after the last batch handed out, with what the
        stream depends on, as JSON bytes."""
        return json.dumps({"next_batch": self._next,
                           **self._identity()}).encode()

    def set_state(self, state: bytes) -> None:
        """Continue after the batch at which ``state`` was taken; the
        stream must be the same (source length, batch, crop, seed, flips,
        shard)."""
        st = json.loads(state.decode())
        mine = self._identity()
        differ = {k: (st.get(k), v) for k, v in mine.items()
                  if st.get(k) != v}
        if differ:
            raise ValueError(f"loader state of another stream: {differ}")
        self.close()
        self._next = self._first = int(st["next_batch"])

    def _start(self) -> None:
        ctx = multiprocessing.get_context("spawn")
        stop = ctx.Event()
        self._queues = [ctx.Queue(maxsize=self.prefetch)
                        for _ in range(self.num_workers)]
        self._procs = [
            ctx.Process(target=_worker, daemon=True,
                        name=f"bin_tpu_torch-loader-{w}",
                        args=(self._stream, self._first + w,
                              self.num_workers, self._queues[w], stop))
            for w in range(self.num_workers)]
        self._finalize = weakref.finalize(self, _shutdown, self._procs,
                                          self._queues, stop)
        for p in self._procs:
            p.start()

    def _receive(self, k: int) -> dict[str, np.ndarray]:
        w = (k - self._first) % self.num_workers
        q, proc = self._queues[w], self._procs[w]
        waited, dead = 0.0, False
        while True:
            try:
                kind, at, payload = q.get(timeout=1.0)
                break
            except queue.Empty:
                waited += 1.0
                if not proc.is_alive():
                    if dead:  # a last look after it died
                        raise RuntimeError(
                            f"loader worker {w} exited with code "
                            f"{proc.exitcode} before batch {k}")
                    dead = True
                elif waited >= self.timeout_s:
                    raise TimeoutError(f"loader worker {w}: no batch {k} "
                                       f"in {self.timeout_s:.0f} s")
        if kind == "error":
            raise RuntimeError(f"loader worker {w} failed at batch {at}:\n"
                               f"{payload}")
        if at != k:
            raise RuntimeError(f"loader worker {w} sent batch {at}, "
                               f"expected {k}")
        return payload

    def __next__(self) -> dict[str, np.ndarray]:
        n = self._stream.num_batches
        if n is not None and self._next >= n:
            raise StopIteration
        try:
            if self.num_workers == 0:
                batch = self._stream.batch(self._next)
            else:
                if not self._procs:
                    self._start()
                batch = self._receive(self._next)
        except BaseException:
            self.close()
            raise
        self._next += 1
        return batch

    def close(self) -> None:
        """Stop and join the workers; the loader can go on after
        ``set_state``, or from where it was if iterated again."""
        if self._finalize is not None:
            self._finalize()
            self._finalize = None
        self._procs, self._queues = [], []
        self._first = self._next
