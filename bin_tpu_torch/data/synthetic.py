"""Synthetic blurry/sharp clip generator, a copy of
``bin_tpu/data/synthetic.py`` (numpy only), so that the port makes the
same clips from the same seed without importing ``bin_tpu``.

The build machine has no Adobe240/GoPro data and no network (SURVEY.md §8
hard part (f)), so all correctness and quality work runs on procedurally
generated clips: smoothly moving Gaussian blobs over a drifting background
gradient, rendered at "240fps" sub-frame resolution, then blurred with the
exact averaging recipe the reference uses offline (mean of ``taps``
consecutive frames, stride ``stride`` — SURVEY.md §4.3).

Determinism: everything derives from an integer seed via
``np.random.Generator(np.random.Philox(seed))`` so loaders are reproducible
across processes (Grain-style determinism, SURVEY.md §6.2).
"""

from __future__ import annotations

import numpy as np

__all__ = ["render_sharp_clip", "render_textured_clip", "synthesize_blur",
           "make_sample", "num_sharp_needed"]


def num_sharp_needed(num_keys: int, taps: int = 11, stride: int = 8) -> int:
    """Sharp 240fps frames required to synthesize ``num_keys`` blurry frames."""
    return (num_keys - 1) * stride + taps


def _smooth_noise(rng: np.random.Generator, height: int, width: int,
                  scale: int) -> np.ndarray:
    """Band-limited (H, W, 3) texture in [0, 1]: box-smoothed white noise."""
    noise = rng.normal(size=(height, width, 3)).astype(np.float32)
    k = max(1, scale)
    cs = np.cumsum(np.cumsum(np.pad(noise, ((k, 0), (k, 0), (0, 0))), 0), 1)
    box = (cs[k:, k:] - cs[:-k, k:] - cs[k:, :-k] + cs[:-k, :-k]) / (k * k)
    lo, hi = box.min(), box.max()
    return (box - lo) / max(hi - lo, 1e-6)


def _bilinear_shift(img: np.ndarray, dy: float, dx: float) -> np.ndarray:
    """Sample ``img`` at (y+dy, x+dx) with bilinear weights, edge-clamped."""
    h, w = img.shape[:2]
    y = np.clip(np.arange(h, dtype=np.float32) + dy, 0, h - 1)
    x = np.clip(np.arange(w, dtype=np.float32) + dx, 0, w - 1)
    y0 = np.floor(y).astype(np.int64)
    x0 = np.floor(x).astype(np.int64)
    y1 = np.minimum(y0 + 1, h - 1)
    x1 = np.minimum(x0 + 1, w - 1)
    wy = (y - y0)[:, None, None]
    wx = (x - x0)[None, :, None]
    a = img[y0][:, x0] * (1 - wy) * (1 - wx) + img[y0][:, x1] * (1 - wy) * wx
    b = img[y1][:, x0] * wy * (1 - wx) + img[y1][:, x1] * wy * wx
    return a + b


def render_textured_clip(seed: int, num_frames: int, height: int, width: int,
                         num_objects: int = 6) -> np.ndarray:
    """Hard variant: textured background + occluding textured rectangles
    with sharp edges and large velocities (VERDICT r1 item 5).

    The smooth-blob scenes leave the no-learning deblur baseline at ~38 dB
    (blur barely hurts smooth gradients), so deblur learning was
    unmeasurable.  Here high-frequency texture + fast motion (up to ~6 px
    per 240fps frame -> ~60 px streaks over an 11-tap blur) pull the blurry
    input down to a realistic ~28-29 dB (SURVEY.md §7 anchors).  Objects are
    drawn back-to-front, so edges occlude and dis-occlude.
    """
    rng = np.random.Generator(np.random.Philox(seed))
    bg = _smooth_noise(rng, height, width, scale=max(4, height // 32))
    bg = 0.15 + 0.7 * bg
    bg_vel = rng.uniform(-1.0, 1.0, size=2).astype(np.float32)

    objs = []
    for _ in range(num_objects):
        oh = int(rng.integers(height // 8, height // 2))
        ow = int(rng.integers(width // 8, width // 2))
        tex = _smooth_noise(rng, oh, ow, scale=max(2, min(oh, ow) // 8))
        tint = rng.uniform(0.3, 1.0, size=3).astype(np.float32)
        objs.append({
            "tex": (0.1 + 0.8 * tex) * tint,
            "pos": rng.uniform([0, 0], [height - oh, width - ow]).astype(np.float32),
            # up to ~±4 px per 240fps frame -> up to ~44 px streaks over an
            # 11-tap blur; lands the blurry-input baseline at a realistic
            # ~27-29 dB (SURVEY.md §7 anchors)
            "vel": rng.uniform(-4.0, 4.0, size=2).astype(np.float32),
            "size": (oh, ow),
        })

    frames = np.empty((num_frames, height, width, 3), dtype=np.float32)
    for t in range(num_frames):
        img = _bilinear_shift(bg, float(bg_vel[0] * t), float(bg_vel[1] * t))
        for o in objs:  # back-to-front: later objects occlude earlier ones
            oh, ow = o["size"]
            py = float(o["pos"][0] + o["vel"][0] * t)
            px = float(o["pos"][1] + o["vel"][1] * t)
            # wrap so objects stay in play over long clips
            py = py % (height + oh) - oh
            px = px % (width + ow) - ow
            iy0, ix0 = int(np.ceil(py)), int(np.ceil(px))
            # subpixel: sample the texture at the fractional offset
            sub = _bilinear_shift(o["tex"], iy0 - py - 0.0, ix0 - px - 0.0)
            y0, y1 = max(iy0, 0), min(iy0 + oh, height)
            x0, x1 = max(ix0, 0), min(ix0 + ow, width)
            if y0 >= y1 or x0 >= x1:
                continue
            img[y0:y1, x0:x1] = sub[y0 - iy0:y1 - iy0, x0 - ix0:x1 - ix0]
        np.clip(img, 0.0, 1.0, out=img)
        frames[t] = img
    return frames


def render_sharp_clip(seed: int, num_frames: int, height: int, width: int,
                      num_blobs: int = 8, style: str = "smooth") -> np.ndarray:
    """Render (T, H, W, 3) float32 frames in [0, 1].

    style="smooth": moving Gaussian blobs over a gradient (easy; the
    original round-1 content).  style="textured": occluding textured
    rectangles, sharp edges, larger motion (hard; realistic blur damage).

    Motion is linear in time with per-object velocity of a few pixels per
    240fps frame, so an 11-tap average produces realistic motion blur streaks.
    """
    if style == "textured":
        return render_textured_clip(seed, num_frames, height, width)
    if style != "smooth":
        raise ValueError(f"unknown synthetic style {style!r}")
    rng = np.random.Generator(np.random.Philox(seed))
    ys, xs = np.mgrid[0:height, 0:width].astype(np.float32)

    # Background: static low-frequency color gradient + slow global drift.
    freq_y = rng.uniform(0.5, 2.0, size=3).astype(np.float32)
    freq_x = rng.uniform(0.5, 2.0, size=3).astype(np.float32)
    phase = rng.uniform(0, 2 * np.pi, size=3).astype(np.float32)
    drift = rng.uniform(-0.02, 0.02, size=3).astype(np.float32)

    # Blobs: position, velocity, radius, per-channel amplitude.
    pos = rng.uniform([0, 0], [height, width], size=(num_blobs, 2)).astype(np.float32)
    vel = rng.uniform(-3.0, 3.0, size=(num_blobs, 2)).astype(np.float32)
    radius = rng.uniform(min(height, width) * 0.05,
                         min(height, width) * 0.2, size=num_blobs).astype(np.float32)
    amp = rng.uniform(-0.6, 0.6, size=(num_blobs, 3)).astype(np.float32)

    frames = np.empty((num_frames, height, width, 3), dtype=np.float32)
    for t in range(num_frames):
        img = np.empty((height, width, 3), dtype=np.float32)
        for c in range(3):
            img[..., c] = 0.5 + 0.2 * np.sin(
                2 * np.pi * (freq_y[c] * ys / height + freq_x[c] * xs / width)
                + phase[c] + drift[c] * t)
        p = pos + vel * t
        # wrap blob centres so they stay in frame over long clips
        p[:, 0] = np.mod(p[:, 0], height)
        p[:, 1] = np.mod(p[:, 1], width)
        for b in range(num_blobs):
            d2 = (ys - p[b, 0]) ** 2 + (xs - p[b, 1]) ** 2
            g = np.exp(-0.5 * d2 / (radius[b] ** 2))
            img += g[..., None] * amp[b]
        np.clip(img, 0.0, 1.0, out=img)
        frames[t] = img
    return frames


def synthesize_blur(sharp: np.ndarray, taps: int = 11, stride: int = 8) -> np.ndarray:
    """Average ``taps`` consecutive sharp frames with ``stride`` → blurry frames.

    Matches the reference's offline blur-synthesis recipe (SURVEY.md §4.3):
    blurry[k] = mean(sharp[k*stride : k*stride + taps]).
    """
    t = sharp.shape[0]
    num_keys = (t - taps) // stride + 1
    if num_keys <= 0:
        raise ValueError(f"clip of {t} frames too short for taps={taps}")
    cumsum = np.concatenate([np.zeros_like(sharp[:1]),
                             np.cumsum(sharp, axis=0, dtype=np.float32)])
    starts = np.arange(num_keys) * stride
    return (cumsum[starts + taps] - cumsum[starts]) / np.float32(taps)


def gt_indices(num_keys: int, taps: int = 11, stride: int = 8) -> np.ndarray:
    """240fps indices of the 2K-1 supervised sharp timestamps for K keys.

    Key-frame centers sit at ``center + k*stride``; interpolated GT frames
    sit at the true temporal midpoints between consecutive centers. Odd
    strides would put midpoints off the integer 240fps grid (and silently
    misalign supervision with the blurry keys), so they are rejected.
    """
    if stride % 2 != 0:
        raise ValueError(
            f"blur stride must be even so interpolation midpoints land on "
            f"the 240fps frame grid; got stride={stride}")
    center = (taps - 1) // 2
    return center + np.arange(2 * num_keys - 1) * (stride // 2)


def make_sample(seed: int, num_keys: int, height: int, width: int,
                taps: int = 11, stride: int = 8,
                style: str = "smooth") -> dict[str, np.ndarray]:
    """One training/eval sample.

    Returns
      blurry: (K, H, W, 3)      blurry key frames (model input)
      sharp:  (2K-1, H, W, 3)   sharp GT on the 2x output grid
    """
    total = num_sharp_needed(num_keys, taps, stride)
    clip = render_sharp_clip(seed, total, height, width, style=style)
    blurry = synthesize_blur(clip, taps, stride)
    sharp = clip[gt_indices(num_keys, taps, stride)]
    return {"blurry": blurry, "sharp": sharp}
