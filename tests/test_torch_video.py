"""The port's video extraction (``bin_tpu_torch/data/video.py``) against
``bin_tpu``'s: frames from a lossless FFV1 video written by cv2 (skipped
where the codec is absent), byte for byte, through cv2 and through the
imageio fallback, and the chain extract -> prep -> FrameFolderSource."""

import builtins
import os

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from bin_tpu.data import video as jax_video  # noqa: E402
from bin_tpu_torch import cli  # noqa: E402
from bin_tpu_torch.data import video  # noqa: E402
from bin_tpu_torch.data.frames import FrameFolderSource  # noqa: E402


def _pattern(i: int, h: int = 48, w: int = 64) -> np.ndarray:
    y, x = np.mgrid[0:h, 0:w]
    r = ((x + 3 * i) % w * 255 // w).astype(np.uint8)
    g = ((y + 2 * i) % h * 255 // h).astype(np.uint8)
    b = np.full((h, w), (i * 7) % 256, np.uint8)
    return np.stack([r, g, b], axis=-1)


def _write_video(path: str, num_frames: int) -> list[np.ndarray]:
    frames = [_pattern(i) for i in range(num_frames)]
    w = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"FFV1"), 30.0, (64, 48))
    if not w.isOpened():
        pytest.skip("FFV1 codec unavailable in this OpenCV build")
    for f in frames:
        w.write(f[..., ::-1])  # the writer takes BGR
    w.release()
    return frames


def _tree(root) -> dict[str, bytes]:
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            with open(os.path.join(d, n), "rb") as f:
                out[os.path.relpath(os.path.join(d, n), root)] = f.read()
    return out


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    d = tmp_path_factory.mktemp("video")
    path = str(d / "clip.avi")
    return path, _write_video(path, 20)


@pytest.mark.parametrize("kw", [dict(), dict(step=3, max_frames=5),
                                dict(fmt="png"), dict(max_frames=0)])
def test_extract_frames_equal_bin_tpus(clip, tmp_path, kw):
    path, frames = clip
    n = video.extract_frames(path, str(tmp_path / "ours"), **kw)
    assert n == jax_video.extract_frames(path, str(tmp_path / "theirs"), **kw)
    ours, theirs = _tree(tmp_path / "ours"), _tree(tmp_path / "theirs")
    assert sorted(ours) == sorted(theirs) and len(ours) == n
    assert all(ours[k] == theirs[k] for k in ours)
    if not kw:
        for i, want in enumerate(frames):  # FFV1 is lossless
            np.testing.assert_array_equal(
                np.load(tmp_path / "ours" / f"{i:06d}.npy"), want)


def _hide(monkeypatch, *names):
    real = builtins.__import__

    def hidden(name, *args, **kwargs):
        if name.split(".")[0] in names:
            raise ImportError(f"no {name} here")
        return real(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", hidden)


def test_imageio_fallback_equals_bin_tpus(tmp_path, monkeypatch):
    """Without cv2 both packages decode through imageio: an animated GIF
    (which imageio reads through PIL here) as a stand-in video."""
    imageio = pytest.importorskip("imageio.v2")
    path = str(tmp_path / "clip.gif")
    imageio.mimsave(path, [_pattern(i) for i in range(6)])
    _hide(monkeypatch, "cv2")
    ours = list(video.iter_video_frames(path))
    theirs = list(jax_video.iter_video_frames(path))
    assert len(ours) == len(theirs) == 6
    for a, b in zip(ours, theirs):
        assert a.dtype == b.dtype == np.uint8 and a.shape == (48, 64, 3)
        np.testing.assert_array_equal(a, b)
    _hide(monkeypatch, "cv2", "imageio")
    with pytest.raises(ValueError, match="cv2"):
        video.iter_video_frames(path)


def test_errors_as_bin_tpus(clip, tmp_path):
    path, _ = clip
    for mod in (video, jax_video):
        with pytest.raises(FileNotFoundError):
            mod.iter_video_frames(str(tmp_path / "missing.avi"))
        with pytest.raises(ValueError, match="step"):
            mod.extract_frames(path, str(tmp_path / "o"), step=0)
        with pytest.raises(ValueError, match="fmt"):
            mod.extract_frames(path, str(tmp_path / "o"), fmt="jpg")
        with pytest.raises(FileNotFoundError, match="no video files"):
            mod.extract_tree(str(tmp_path), str(tmp_path / "o"))
    assert video.VIDEO_EXTS == jax_video.VIDEO_EXTS


def test_extract_cli_then_prep_then_the_source(tmp_path, capsys):
    """Two videos extracted by the CLI (a folder, then one file), blurred
    by prep, loaded by FrameFolderSource: equal to bin_tpu's chain."""
    vids = tmp_path / "vids"
    vids.mkdir()
    _write_video(str(vids / "a.avi"), 35)
    _write_video(str(vids / "b.avi"), 43)
    cli.main(["extract", "--videos", str(vids), "--out",
              str(tmp_path / "frames")])
    cli.main(["extract", "--videos", str(vids / "a.avi"), "--out",
              str(tmp_path / "one"), "--step", "2"])
    out = capsys.readouterr().out
    assert "extracted 2 videos" in out and "extracted 18 frames" in out
    jax_video.extract_tree(str(vids), str(tmp_path / "jframes"),
                           verbose=False)
    ours, theirs = _tree(tmp_path / "frames"), _tree(tmp_path / "jframes")
    assert sorted(ours) == sorted(theirs) and len(ours) == 35 + 43
    assert all(ours[k] == theirs[k] for k in ours)
    cli.main(["prep", str(tmp_path / "frames"), str(tmp_path / "tree")])
    src = FrameFolderSource(str(tmp_path / "tree"), num_keys=None)
    assert [src[i]["blurry"].shape[0] for i in range(len(src))] == [4, 5]
