"""The port's training stream on the CPU against ``bin_tpu``'s: the cached
u8 synthetic source, the crop and flips, and ``train_iterator``'s batches,
byte for byte for a seed (the same numpy code and draws; the float crop
rounds as ``bin_tpu``'s native ``crop_norm_u8``); and the trainer's source.
"""

import threading

import numpy as np
import pytest

from bin_tpu.config import get_config as jax_get_config
from bin_tpu.data import fastops
from bin_tpu.data.pipeline import SyntheticSource as JaxSource
from bin_tpu.data.pipeline import train_iterator as jax_train_iterator
from bin_tpu.training.trainer import _make_source as jax_make_source
from bin_tpu_torch.config import get_config
from bin_tpu_torch.data.pipeline import (SyntheticSource, crop_norm_u8,
                                         train_iterator)
from bin_tpu_torch.training.trainer import _make_source


@pytest.mark.parametrize("keep_u8,flip", [(True, True), (False, True),
                                          (False, False)])
def test_train_batches_equal_bin_tpu(keep_u8, flip):
    kw = dict(num_samples=3, num_keys=5, height=40, width=44, seed=2,
              cache=True, as_u8=True, style="textured")
    ours = train_iterator(SyntheticSource(**kw), 2, (32, 32), seed=5,
                          random_flip=flip, keep_u8=keep_u8)
    theirs = jax_train_iterator(JaxSource(**kw), 2, (32, 32), seed=5,
                                random_flip=flip, keep_u8=keep_u8)
    for _ in range(4):
        a, b = next(ours), next(theirs)
        assert a.keys() == b.keys() == {"blurry", "sharp"}
        for k in b:
            assert a[k].dtype == b[k].dtype == (np.uint8 if keep_u8
                                                else np.float32)
            assert a[k].shape == b[k].shape and np.array_equal(a[k], b[k]), k
    ours.close()


def test_float_source_batches_equal_bin_tpu():
    kw = dict(num_samples=2, num_keys=4, height=36, width=36, seed=1)
    a = next(train_iterator(SyntheticSource(**kw), 2, (32, 32), seed=0))
    b = next(jax_train_iterator(JaxSource(**kw), 2, (32, 32), seed=0))
    assert all(a[k].dtype == np.float32 and np.array_equal(a[k], b[k])
               for k in b)


@pytest.mark.parametrize("flips", [(False, False, False), (True, False, True),
                                   (False, True, False), (True, True, True)])
def test_crop_norm_u8_rounds_as_bin_tpus_native(flips):
    x = np.random.default_rng(0).integers(0, 256, (3, 20, 24, 3), np.uint8)
    ours = crop_norm_u8(x, 3, 5, 16, 12, *flips)
    theirs = fastops.crop_norm_u8(x, 3, 5, 16, 12, *flips)
    assert ours.dtype == np.float32 and np.array_equal(ours, theirs)


def test_closing_the_iterator_stops_its_thread():
    it = train_iterator(SyntheticSource(2, 4, 36, 36, seed=0), 1, (32, 32),
                        prefetch=1)
    next(it)
    it.close()
    assert not any(t.name == "train-iterator" and t.is_alive()
                   for t in threading.enumerate())


def test_trainer_source_equals_bin_tpus():
    sets = ["data.crop_size=32,32", "data.seq_len=5"]
    ours = _make_source(get_config("config3_prf", sets))
    theirs = jax_make_source(jax_get_config("config3_prf", sets))
    assert (len(ours), ours.height, ours.width, ours.num_keys) == (
        len(theirs), theirs.height, theirs.width, theirs.num_keys)
    for i in (0, 255):
        a, b = ours[i], theirs[i]
        assert a is ours[i]  # cached
        assert all(a[k].dtype == np.uint8 and np.array_equal(a[k], b[k])
                   for k in b)
