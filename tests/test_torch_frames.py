"""The port's frame-folder datasets (``bin_tpu_torch/data/{frames,blur}.py``)
against ``bin_tpu``'s: the prep tool's trees byte for byte, and
``FrameFolderSource``'s samples, names and errors, on the tiny rendered
clips of ``tests/test_frames.py``."""

import os
import pickle

import numpy as np
import pytest

from bin_tpu.data import frames as jax_frames
from bin_tpu.data.blur import synthesize_tree as jax_synthesize_tree
from bin_tpu_torch import cli
from bin_tpu_torch.data import frames, synthetic
from bin_tpu_torch.data.blur import synthesize_tree


def _files(root) -> dict[str, bytes]:
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            p = os.path.join(d, n)
            with open(p, "rb") as f:
                out[os.path.relpath(p, root)] = f.read()
    return out


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """Three tiny 240 fps clips (4, 5 and 6 keys after prep), prepped by
    both packages, as .npy and .png."""
    root = tmp_path_factory.mktemp("frames")
    src = root / "raw240"
    for clip_id, seed, n in (("clipA", 1, 35), ("clipB", 2, 43),
                             ("clipC", 3, 51)):
        d = src / clip_id
        d.mkdir(parents=True)
        for i, frame in enumerate(synthetic.render_sharp_clip(seed, n, 24, 32)):
            np.save(d / f"{i:06d}.npy", (frame * 255 + 0.5).astype(np.uint8))
    out = {}
    for fmt in ("npy", "png"):
        ours, theirs = root / f"port_{fmt}", root / f"jax_{fmt}"
        assert synthesize_tree(str(src), str(ours), fmt=fmt,
                               verbose=False) == 3
        assert jax_synthesize_tree(str(src), str(theirs), fmt=fmt,
                                   verbose=False) == 3
        out[fmt] = (ours, theirs)
    out["src"] = src
    return out


@pytest.mark.parametrize("fmt", ["npy", "png"])
def test_prep_tree_equals_bin_tpus_byte_for_byte(trees, fmt):
    ours, theirs = trees[fmt]
    a, b = _files(ours), _files(theirs)
    assert sorted(a) == sorted(b) and len(a) == (4 + 5 + 6) + (7 + 9 + 11)
    assert all(a[k] == b[k] for k in a)
    assert len(os.listdir(ours / "blurry" / "clipC")) == 6
    assert len(os.listdir(ours / "sharp" / "clipC")) == 11


def test_prep_cli_writes_the_same_tree(trees, tmp_path, capsys):
    cli.main(["prep", str(trees["src"]), str(tmp_path / "t"), "--taps", "11",
              "--stride", "8"])
    assert "wrote 3 clips" in capsys.readouterr().out
    a, b = _files(tmp_path / "t"), _files(trees["npy"][0])
    assert sorted(a) == sorted(b) and all(a[k] == b[k] for k in a)


def test_prep_blur_is_the_mean_of_its_taps(trees):
    ours, _ = trees["npy"]
    clip = synthetic.render_sharp_clip(2, 43, 24, 32)
    u8 = (clip * 255 + 0.5).astype(np.uint8).astype(np.float32) / 255
    got = np.load(ours / "blurry" / "clipB" / "000002.npy")
    want = (u8[16:27].mean(axis=0) * 255 + 0.5).astype(np.uint8)
    np.testing.assert_array_equal(got, want)


def _same(ours: dict, theirs: dict) -> None:
    assert sorted(ours) == sorted(theirs)
    for k in ours:
        assert ours[k].dtype == theirs[k].dtype, k
        np.testing.assert_array_equal(ours[k], theirs[k])


@pytest.mark.parametrize("kw", [
    dict(num_keys=4, chunk_stride=1), dict(num_keys=3), dict(num_keys=None),
    dict(num_keys=4, raw_u8=True), dict(num_keys=4, cache_frames=True),
    dict(num_keys=None, resize_to=(16, 20)),
    dict(num_keys=2, resize_to=(24, 32))])
@pytest.mark.parametrize("fmt", ["npy", "png"])
def test_source_samples_equal_bin_tpus(trees, kw, fmt):
    root = str(trees[fmt][0])
    ours = frames.FrameFolderSource(root, **kw)
    theirs = jax_frames.FrameFolderSource(root, **kw)
    assert len(ours) == len(theirs) and ours.index == theirs.index
    for i in range(len(ours)):
        assert ours.sample_name(i) == theirs.sample_name(i)
        _same(ours[i], theirs[i])


def test_clip_list_restricts_and_orders(trees, tmp_path):
    root = str(trees["npy"][0])
    lst = tmp_path / "test.txt"
    lst.write_text("# split\nclipC\n\nclipA  # first chunk\n")
    ours = frames.FrameFolderSource(root, num_keys=None, clip_list=str(lst))
    theirs = jax_frames.FrameFolderSource(root, num_keys=None,
                                          clip_list=str(lst))
    assert [ours.sample_name(i) for i in range(len(ours))] == [
        "clipC", "clipA"]
    assert ours.index == theirs.index
    for i in range(len(ours)):
        _same(ours[i], theirs[i])


@pytest.mark.parametrize("text,match", [
    ("# nothing\n\n", "empty"), ("clipA\nclipA\n", "duplicates"),
    ("clipA\nclipZ\n", "missing on disk")])
def test_clip_list_errors_as_bin_tpus(trees, tmp_path, text, match):
    lst = tmp_path / "bad.txt"
    lst.write_text(text)
    for mod in (frames, jax_frames):
        with pytest.raises(ValueError, match=match):
            mod.FrameFolderSource(str(trees["npy"][0]), clip_list=str(lst))


def test_source_errors_as_bin_tpus(trees, tmp_path):
    root = str(trees["npy"][0])
    for mod in (frames, jax_frames):
        with pytest.raises(FileNotFoundError):
            mod.FrameFolderSource(str(tmp_path / "nowhere"))
        with pytest.raises(ValueError, match="no usable samples"):
            mod.FrameFolderSource(root, num_keys=7)
        with pytest.raises(ValueError, match="mutually exclusive"):
            mod.FrameFolderSource(root, raw_u8=True, resize_to=(8, 8))


def test_a_cached_source_pickles_with_an_empty_cache(trees):
    src = frames.FrameFolderSource(str(trees["npy"][0]), num_keys=4,
                                   cache_frames=True)
    first = src[0]
    assert src._load.cache_info().currsize > 0
    copy = pickle.loads(pickle.dumps(src))
    assert copy._load.cache_info().currsize == 0
    _same(copy[0], first)


def test_pil_is_named_where_it_is_missing(monkeypatch, trees):
    import builtins
    real = builtins.__import__

    def no_pil(name, *args, **kwargs):
        if name == "PIL" or name.startswith("PIL."):
            raise ImportError("no PIL here")
        return real(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_pil)
    npy = frames.FrameFolderSource(str(trees["npy"][0]), num_keys=4)
    assert npy[0]["blurry"].shape == (4, 24, 32, 3)  # .npy needs no PIL
    png = frames.FrameFolderSource(str(trees["png"][0]), num_keys=4)
    with pytest.raises(ImportError, match="Pillow"):
        png[0]
