"""The port's deterministic loader (``bin_tpu_torch/data/loader.py``)
against ``bin_tpu``'s grain loader (``bin_tpu/data/grain_pipeline.py``):
grain's shuffle bit for bit, the batches for the same source, seed, batch
and crop, the same batches whatever the worker count, exact resumption,
and workers that stop on close and on error.  Every loader with workers
waits at most ``timeout_s`` for a batch, so no test can hang on one."""

import json
import os

import numpy as np
import pytest
from grain._src.python.experimental.index_shuffle.python import (
    index_shuffle_module as grain_shuffle)

from bin_tpu.data.blur import synthesize_tree as jax_synthesize_tree
from bin_tpu.data.frames import FrameFolderSource as JaxFolderSource
from bin_tpu.data.grain_pipeline import grain_train_iterator
from bin_tpu.data.pipeline import SyntheticSource as JaxSource
from bin_tpu_torch.data import synthetic
from bin_tpu_torch.data.frames import FrameFolderSource
from bin_tpu_torch.data.loader import WorkerLoader, index_shuffle
from bin_tpu_torch.data.pipeline import SyntheticSource

TIMEOUT_S = 60


@pytest.mark.parametrize("length", [1, 2, 3, 13, 256, 1000, 65536, 65537,
                                    300001])
@pytest.mark.parametrize("seed", [0, 7, 2**32 - 1])
def test_index_shuffle_equals_grains(seed, length):
    idx = np.arange(min(length, 2000))
    want = [grain_shuffle.index_shuffle(int(i), max_index=length - 1,
                                        seed=seed, rounds=4) for i in idx]
    np.testing.assert_array_equal(index_shuffle(idx, length - 1, seed), want)
    if length <= 65536:  # each epoch is a permutation of its records
        # (not at 65537 in grain either: its last index wraps to block 0)
        perm = index_shuffle(np.arange(length), length - 1, seed)
        assert sorted(perm.tolist()) == list(range(length))


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """Three tiny clips (4, 5 and 6 keys) prepped by bin_tpu's tool."""
    root = tmp_path_factory.mktemp("loader")
    for clip_id, seed, n in (("a", 1, 35), ("b", 2, 43), ("c", 3, 51)):
        d = root / "raw" / clip_id
        d.mkdir(parents=True)
        for i, frame in enumerate(synthetic.render_sharp_clip(seed, n, 40, 48)):
            np.save(d / f"{i:06d}.npy", (frame * 255 + 0.5).astype(np.uint8))
    jax_synthesize_tree(str(root / "raw"), str(root / "tree"), verbose=False)
    return str(root / "tree")


def _same(a: dict, b: dict) -> None:
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _sources(kind: str, tree: str):
    if kind == "folder":
        return (FrameFolderSource(tree, num_keys=3, chunk_stride=1,
                                  raw_u8=True),
                JaxFolderSource(tree, num_keys=3, chunk_stride=1,
                                raw_u8=True))
    return (SyntheticSource(10, 4, 24, 28, seed=1, cache=True, as_u8=True),
            JaxSource(10, 4, 24, 28, seed=1, cache=True, as_u8=True))


@pytest.mark.parametrize("kind,kw", [
    ("folder", dict(batch_size=4, seed=5, keep_u8=True)),
    ("folder", dict(batch_size=3, seed=0, keep_u8=False, random_flip=False)),
    ("synthetic", dict(batch_size=2, seed=3, keep_u8=True, shard_index=1,
                       shard_count=3)),
    ("synthetic", dict(batch_size=3, seed=2, keep_u8=False, num_epochs=2))])
def test_batches_equal_bin_tpus_grain_iterator(tree, kind, kw):
    """Over several epochs; with num_epochs the streams end together."""
    ours_src, theirs_src = _sources(kind, tree)
    theirs = list(zip(range(9), grain_train_iterator(theirs_src, crop_size=(
        16, 24), **kw)))
    with WorkerLoader(ours_src, crop_size=(16, 24), **kw) as ours:
        got = list(zip(range(9), ours))
    assert len(got) == len(theirs) == (6 if "num_epochs" in kw else 9)
    for (_, a), (_, b) in zip(got, theirs):
        _same(a, b)


def test_batches_are_the_same_whatever_the_worker_count(tree):
    src = FrameFolderSource(tree, num_keys=3, chunk_stride=1, raw_u8=True)
    runs = []
    for workers in (0, 2, 3):
        with WorkerLoader(src, 2, (16, 16), seed=4, keep_u8=True,
                          num_workers=workers, timeout_s=TIMEOUT_S) as ld:
            runs.append([next(ld) for _ in range(7)])
    for other in runs[1:]:
        for a, b in zip(runs[0], other):
            _same(a, b)


@pytest.mark.parametrize("workers", [0, 2])
def test_resume_from_get_state_is_exact(workers):
    src = SyntheticSource(9, 4, 24, 24, seed=2, cache=True, as_u8=True)
    with WorkerLoader(src, 2, (16, 16), seed=1, num_workers=workers,
                      timeout_s=TIMEOUT_S) as ld:
        straight = [next(ld) for _ in range(4)]
        state = ld.get_state()
        straight += [next(ld) for _ in range(4)]
    assert json.loads(state)["next_batch"] == 4
    with WorkerLoader(src, 2, (16, 16), seed=1, num_workers=workers,
                      timeout_s=TIMEOUT_S) as ld:
        ld.set_state(state)
        resumed = [next(ld) for _ in range(4)]
    for a, b in zip(resumed, straight[4:]):
        _same(a, b)


@pytest.mark.parametrize("change", [dict(seed=2), dict(batch_size=3),
                                    dict(crop_size=(8, 8))])
def test_state_of_another_stream_is_refused(change):
    src = SyntheticSource(4, 4, 24, 24, seed=2)
    kw = dict(batch_size=2, crop_size=(16, 16), seed=1)
    state = WorkerLoader(src, **kw).get_state()
    with pytest.raises(ValueError, match="another stream"):
        WorkerLoader(src, **{**kw, **change}).set_state(state)


def test_a_worker_error_is_raised_and_the_workers_stop(tmp_path, tree):
    import shutil
    root = tmp_path / "tree"
    shutil.copytree(tree, root)
    src = FrameFolderSource(str(root), num_keys=3, chunk_stride=1,
                            raw_u8=True)
    for d in (root / "blurry", root / "sharp"):
        for clip in os.listdir(d):
            for f in os.listdir(d / clip):
                os.remove(d / clip / f)
    ld = WorkerLoader(src, 2, (16, 16), num_workers=2, timeout_s=TIMEOUT_S)
    with pytest.raises(RuntimeError, match="FileNotFoundError"):
        next(ld)
    assert ld._procs == []  # closed on the error


def test_close_stops_the_workers():
    src = SyntheticSource(6, 4, 24, 24, seed=2, cache=True)
    ld = WorkerLoader(src, 2, (16, 16), num_workers=2, timeout_s=TIMEOUT_S)
    first = next(ld)
    procs = list(ld._procs)
    assert len(procs) == 2 and all(p.is_alive() for p in procs)
    ld.close()
    assert all(p.exitcode is not None for p in procs)
    # iterated again, it goes on from where it was
    second = next(ld)
    ld.close()
    with WorkerLoader(src, 2, (16, 16), timeout_s=TIMEOUT_S) as ref:
        _same(first, next(ref))
        _same(second, next(ref))
