"""Video to frame folders, a copy of ``bin_tpu/data/video.py`` (``python
-m bin_tpu_torch.cli extract``), the first stage of data preparation:

    python -m bin_tpu_torch.cli extract --videos raw_videos/ --out frames/
    python -m bin_tpu_torch.cli prep frames/ dataset/   # 11 taps, stride 8

Frames are decoded one at a time (O(1) memory in the clip's length) with
OpenCV, whose BGR is swapped to RGB, or with imageio where cv2 is not
installed; both are imported only here, and an error names them when
neither is.  Frames are written as uint8 ``.npy`` by default (``png`` needs
PIL); ``step`` keeps every step-th frame (a 240 fps source at step 2 gives
120 fps).
"""

from __future__ import annotations

import os
from typing import Iterator

import numpy as np

from bin_tpu_torch.data.frames import pil_image

__all__ = ["VIDEO_EXTS", "iter_video_frames", "extract_frames",
           "extract_tree", "extract_cli"]

# extensions taken as video inputs (demo --input, extract_tree's scan)
VIDEO_EXTS = (".avi", ".mp4", ".mov", ".mkv", ".webm", ".m4v", ".mpg",
              ".mpeg", ".wmv")


def iter_video_frames(path: str) -> Iterator[np.ndarray]:
    """The frames of a video file as uint8 RGB (H, W, 3), one at a time.

    Raises at call time, not at the first ``next()``: FileNotFoundError
    for a missing file, ValueError where no backend opens it."""
    if not os.path.isfile(path):
        raise FileNotFoundError(path)
    try:
        import cv2
    except ImportError:
        cv2 = None
    if cv2 is not None:
        cap = cv2.VideoCapture(path)
        if not cap.isOpened():
            cap.release()
            raise ValueError(f"could not open video: {path}")

        def _cv2_frames() -> Iterator[np.ndarray]:
            try:
                while True:
                    ok, frame = cap.read()
                    if not ok:
                        return
                    yield np.ascontiguousarray(frame[..., ::-1])  # BGR → RGB
            finally:
                cap.release()

        return _cv2_frames()
    try:
        import imageio.v2 as imageio
    except ImportError as e:
        raise ValueError(
            "neither cv2 (opencv-python) nor imageio is available to "
            f"decode {path}") from e
    reader = imageio.get_reader(path)

    def _imageio_frames() -> Iterator[np.ndarray]:
        try:
            for frame in reader:
                frame = np.asarray(frame)
                if frame.ndim == 2:
                    frame = np.repeat(frame[..., None], 3, axis=-1)
                yield frame[..., :3].astype(np.uint8, copy=False)
        finally:
            reader.close()

    return _imageio_frames()


def _write_frame(frame: np.ndarray, out_dir: str, index: int,
                 fmt: str) -> None:
    name = os.path.join(out_dir, f"{index:06d}.{fmt}")
    if fmt == "npy":
        np.save(name, frame)
    elif fmt == "png":
        pil_image().fromarray(frame).save(name)
    else:
        raise ValueError(f"fmt must be 'npy' or 'png', got {fmt!r}")


def extract_frames(src: str, out_dir: str, *, step: int = 1,
                   max_frames: int | None = None, fmt: str = "npy") -> int:
    """Decode ``src`` and write every ``step``-th frame to ``out_dir`` as
    ``000000.<fmt>``, ``000001.<fmt>``, ... (numbered densely after the
    step).  Returns the frames written.  The arguments are checked before
    any file is read."""
    if step < 1:
        raise ValueError(f"step must be >= 1, got {step}")
    if max_frames is not None and max_frames < 0:
        raise ValueError(f"max_frames must be >= 0, got {max_frames}")
    if fmt not in ("npy", "png"):
        raise ValueError(f"fmt must be 'npy' or 'png', got {fmt!r}")
    os.makedirs(out_dir, exist_ok=True)
    written = 0
    for i, frame in enumerate(iter_video_frames(src)):
        if i % step:
            continue
        if max_frames is not None and written >= max_frames:
            break
        _write_frame(frame, out_dir, written, fmt)
        written += 1
    return written


def extract_tree(videos_dir: str, out_dir: str, *, step: int = 1,
                 max_frames: int | None = None, fmt: str = "npy",
                 verbose: bool = True) -> int:
    """Extract every video under ``videos_dir`` to ``out_dir/<stem>/``, the
    layout ``blur.synthesize_tree`` reads.  Returns the videos extracted;
    a folder with no video raises FileNotFoundError."""
    if not os.path.isdir(videos_dir):
        raise FileNotFoundError(videos_dir)
    vids = sorted(
        os.path.join(root, f)
        for root, _dirs, files in os.walk(videos_dir)
        for f in files if f.lower().endswith(VIDEO_EXTS))
    if not vids:
        raise FileNotFoundError(
            f"no video files ({'/'.join(VIDEO_EXTS)}) under {videos_dir}")
    for path in vids:
        stem = os.path.splitext(os.path.basename(path))[0]
        n = extract_frames(path, os.path.join(out_dir, stem), step=step,
                           max_frames=max_frames, fmt=fmt)
        if verbose:
            print(f"{path} → {out_dir}/{stem}: {n} frames")
    return len(vids)


def extract_cli(argv: list[str] | None = None) -> None:
    """Videos to frame folders (the first stage of data preparation)."""
    import argparse

    p = argparse.ArgumentParser(description=extract_cli.__doc__)
    p.add_argument("--videos", required=True,
                   help="a video file or a directory of videos")
    p.add_argument("--out", required=True, help="output frame-folder root")
    p.add_argument("--step", type=int, default=1,
                   help="keep every step-th frame (fps down-conversion)")
    p.add_argument("--max-frames", type=int, default=None,
                   help="cap frames per video")
    p.add_argument("--fmt", default="npy", choices=("npy", "png"),
                   help="frame format (npy = loader-native, png = portable)")
    args = p.parse_args(argv)
    if os.path.isdir(args.videos):
        n = extract_tree(args.videos, args.out, step=args.step,
                         max_frames=args.max_frames, fmt=args.fmt)
        print(f"extracted {n} videos → {args.out}")
    else:
        stem = os.path.splitext(os.path.basename(args.videos))[0]
        n = extract_frames(args.videos, os.path.join(args.out, stem),
                           step=args.step, max_frames=args.max_frames,
                           fmt=args.fmt)
        print(f"extracted {n} frames → {args.out}/{stem}")
