"""Calibrate the static int8 activation scales of the serving mode
(``tools/calibrate_int8.py``), on the card.

    python -m bin_tpu_torch.calibrate --checkpoint weights/prf_ema_r4.npz \\
        --out weights/prf_ema_r4.scales.npz [--preset config3_prf] \\
        [--size 256 [256]] [--keys 12] [--clips 8] [--seed 1234] \\
        [--margin 1.0] [--ema] [--set KEY=VALUE ...] [--device cuda|cpu]

The serving mode quantizes each int8 conv's input on one static scale
(``model.conv_int8_static``) instead of its abs-max per call.  Method, as
the tool's: the model in ``model.conv_int8_calibrate`` mode (float convs,
each backbone 3x3 conv and each ConvLSTM's two gate inputs recording the
abs-max of what they see; ``models/pyramid.py``), in bf16 with the
producer-side clamp of inference, over ``--clips`` clips of the synthetic
stream with the real sliding-window recurrence (the ConvLSTM's carried
state needs warmed-up windows); the max over all windows and clips, then
``scale = float32(max(amax, 1e-8) * margin / 127)`` per key.  The maxima
stay on the device until the end: one host sync in all.  The clips render
in threads while the card runs the earlier ones.  The file is
``np.savez`` with ``__calibrated_for__``, the weights' basename, beside the
scales under ``bin_tpu``'s flax path keys, so that ``bin_tpu``'s
``load_act_scales`` and the port's read it alike.

The seed (1234) is deliberately not the pinned eval's 9999, so that the
quality gate scores data the calibration never saw.  The scales are read
once per path and process (``ops/quant.load_act_scales``): serve from a
fresh process after calibrating again.  Prints one JSON line on stdout;
the progress goes to stderr.  Runs on the card unless ``--device cpu``;
without a card it raises.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Iterable

import numpy as np
import torch

from bin_tpu_torch.config import Config, apply_model_overrides, get_config
from bin_tpu_torch.registry import Model, build_model

__all__ = ["calibration_model", "calibrate", "write_scales", "main"]


def calibration_model(cfg: Config, params: dict,
                      device: torch.device | str = "cuda",
                      dtype: str = "bfloat16") -> Model:
    """``cfg.model`` in calibration mode and ``dtype``, holding ``params``
    (a flax tree) in the inference form."""
    mcfg = apply_model_overrides(cfg.model, ["model.conv_int8_calibrate=true",
                                             f"model.dtype={dtype}"])
    return build_model(mcfg, device).load_params(params)


def calibrate(model: Model, clips: Iterable[np.ndarray],
              margin: float = 1.0) -> dict[str, np.float32]:
    """{flax path key -> static scale} from the abs-maxima that
    ``infer_clip`` of every clip (1, K, H, W, 3) records in ``model``, a
    ``calibration_model``; the maxima start again from 0."""
    model.module.reset_quant_stats()
    for clip in clips:
        model.infer_clip(torch.as_tensor(clip))
    amax = {k: float(v) for k, v in model.module.quant_stats.items()}
    return {k: np.float32(max(a, 1e-8) * margin / 127.0)
            for k, a in sorted(amax.items())}


def write_scales(path: str, scales: dict, weights: str) -> None:
    """The sidecar at ``path``: the scales and ``__calibrated_for__``, the
    basename of the weights they were calibrated on."""
    np.savez(path, __calibrated_for__=np.str_(os.path.basename(
        str(weights).rstrip("/"))), **scales)


def main(argv: list[str] | None = None) -> dict:
    from bin_tpu_torch.data.pipeline import SyntheticSource
    from bin_tpu_torch.training.checkpoint import restore_params

    ap = argparse.ArgumentParser(
        description="Calibrate static int8 activation scales for serving.")
    ap.add_argument("--checkpoint", required=True,
                    help="release .npz or checkpoint directory")
    ap.add_argument("--preset", default="config3_prf")
    ap.add_argument("--out", required=True, help="output scales .npz")
    ap.add_argument("--size", type=int, nargs="+", default=[256],
                    help="calibration clip size (H [W])")
    ap.add_argument("--keys", type=int, default=12)
    ap.add_argument("--clips", type=int, default=8)
    ap.add_argument("--seed", type=int, default=1234,
                    help="calibration seed, not the pinned eval's 9999")
    ap.add_argument("--margin", type=float, default=1.0,
                    help="factor on the observed abs-max (> 1: headroom "
                         "for unseen outliers, at a coarser grid)")
    ap.add_argument("--ema", action="store_true",
                    help="the EMA of a checkpoint directory")
    ap.add_argument("--set", action="append", default=[], metavar="KEY=VALUE",
                    help="config override over the preset, e.g. "
                         "model.base_features=8")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    h = args.size[0]
    w = args.size[1] if len(args.size) > 1 else h
    cfg = get_config(args.preset, args.set)
    t0 = time.perf_counter()
    model = calibration_model(cfg, restore_params(args.checkpoint,
                                                  ema=args.ema), args.device)
    source = SyntheticSource(num_samples=args.clips, num_keys=args.keys,
                             height=h, width=w, seed=args.seed,
                             style=cfg.data.synthetic_style)

    def clips(pool):
        # rendered in threads (numpy releases the GIL), ahead of the card
        for i, sample in enumerate(pool.map(source.__getitem__,
                                            range(len(source)))):
            yield sample["blurry"][None]
            print(f"clip {i + 1}/{len(source)} done", file=sys.stderr,
                  flush=True)

    with ThreadPoolExecutor(min(len(source), os.cpu_count() or 1)) as pool:
        scales = calibrate(model, clips(pool), args.margin)
    write_scales(args.out, scales, args.checkpoint)
    record = {"out": args.out, "checkpoint": args.checkpoint,
              "keys": len(scales), "margin": args.margin,
              "clips": args.clips, "size": [h, w], "num_keys": args.keys,
              "seed": args.seed, "device": str(model.device),
              "seconds": time.perf_counter() - t0}
    for key, value in scales.items():
        print(f"  {key}: {value:.6f}", file=sys.stderr)
    print(json.dumps(record), flush=True)
    return record


if __name__ == "__main__":
    main()
