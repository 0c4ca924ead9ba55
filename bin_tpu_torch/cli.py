"""Command-line entry points of the port, those of ``bin_tpu/cli.py``:

    python -m bin_tpu_torch.cli train   --preset P [--set K=V] [--steps N]
                                        [--workdir D] [--init-from C]
    python -m bin_tpu_torch.cli eval    --preset P [--set K=V] [--checkpoint C]
                                        [--ema] [--num-clips N] [--save-dir D]
                                        [--self-ensemble]
    python -m bin_tpu_torch.cli bench   [bench_torch.py's arguments]
    python -m bin_tpu_torch.cli prep    SRC_ROOT DST_ROOT [--taps] [--stride]
                                        [--format npy|png]
    python -m bin_tpu_torch.cli extract --videos V --out D [--step] [--fmt]
    python -m bin_tpu_torch.cli export  --preset P --checkpoint C --out F.npz
                                        [--ema] [--note] [--store-dtype]
                                        [--eval-json J]
    python -m bin_tpu_torch.cli demo    --weights F.npz [--input synthetic|
                                        FOLDER|VIDEO] [--out D]
    python -m bin_tpu_torch.cli import-torch --preset P --torch-checkpoint
                                        T.pth --out F.npz [--rules R.json]
                                        [--gate-reorder 0,2,1,3] [--no-strict]

A checkpoint ``C`` is a checkpoint directory of the port's trainer
(``<workdir>/checkpoints``) or a release ``.npz``.  ``--device cuda`` (the
default; it raises without a card) or ``--device cpu`` takes the place of
``bin_tpu``'s JAX-only ``--platform``.  ``train``, ``eval`` and ``export``
print one JSON line of their result on stdout.  ``train`` and ``eval``
started by ``torchrun`` (``python -m torch.distributed.run``) split the
batch, or the clips, over its ranks (``parallel/``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

__all__ = ["main", "parse_config", "COMMANDS"]


def _base_parser(prog: str, description: str) -> argparse.ArgumentParser:
    from bin_tpu_torch.config import PRESETS

    p = argparse.ArgumentParser(prog=f"python -m bin_tpu_torch.cli {prog}",
                                description=description)
    p.add_argument("--preset", default="config1_backbone_128",
                   choices=sorted(PRESETS), help="named config preset")
    p.add_argument("--set", dest="overrides", action="append", default=[],
                   metavar="KEY=VALUE", help="dotted config override, repeatable")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    return p


def parse_config(argv: list[str] | None, prog: str, description: str,
                 extra_args: dict[str, dict] | None = None):
    """(config, arguments) of a command that takes a preset."""
    from bin_tpu_torch.config import get_config

    p = _base_parser(prog, description)
    for name, kwargs in (extra_args or {}).items():
        p.add_argument(name, **kwargs)
    args = p.parse_args(argv)
    return get_config(args.preset, args.overrides), args


def train_main(argv: list[str] | None = None) -> None:
    from bin_tpu_torch.training import checkpoint as ckpt
    from bin_tpu_torch.training.trainer import train

    cfg, args = parse_config(argv, "train", "Train a bin_tpu model.", {
        "--steps": dict(type=int, default=None,
                        help="total steps (default optim.num_steps)"),
        "--workdir": dict(default="runs/latest", help="checkpoints + logs dir"),
        "--init-from": dict(default="", help="warm-start the parameters from "
                            "a checkpoint directory or .npz (fresh "
                            "optimizer)"),
    })
    _, state = train(cfg, workdir=args.workdir, num_steps=args.steps,
                     init_params_from=args.init_from, device=args.device)
    print(json.dumps({"step": state.step, "workdir": args.workdir,
                      "checkpoint": ckpt.latest_step(os.path.join(
                          args.workdir, cfg.checkpoint.directory)),
                      "skipped_steps": int(state.total_notfinite)}),
          flush=True)


def eval_main(argv: list[str] | None = None) -> None:
    from bin_tpu_torch.evaluation.evaluator import evaluate_cli

    cfg, args = parse_config(argv, "eval", "Evaluate PSNR/SSIM of a model.", {
        "--checkpoint": dict(default="", help="checkpoint directory or .npz "
                             "(empty = random init)"),
        "--num-clips": dict(type=int, default=None,
                            help="eval clips (default: the preset's pinned "
                                 "eval protocol, data.eval_num_clips)"),
        "--save-dir": dict(default="", help="write output frames as PNGs here"),
        "--ema": dict(action="store_true",
                      help="evaluate the EMA params (optim.ema_decay runs)"),
        "--self-ensemble": dict(action="store_true",
                                help="average the 4 spatial-flip predictions "
                                     "(4x compute; not comparable with "
                                     "plain evals)"),
    })
    results = evaluate_cli(cfg, checkpoint=args.checkpoint,
                           num_clips=args.num_clips, save_dir=args.save_dir,
                           ema=args.ema, self_ensemble=args.self_ensemble,
                           device=args.device)
    print(json.dumps(results), flush=True)


def bench_main(argv: list[str] | None = None) -> None:
    from bin_tpu_torch.benchmark import main
    main(argv)


def prep_main(argv: list[str] | None = None) -> None:
    """Blur synthesis over a folder of 240 fps frames (data/blur.py)."""
    from bin_tpu_torch.data.blur import prep_cli
    prep_cli(argv)


def extract_main(argv: list[str] | None = None) -> None:
    """Videos to frame folders (data/video.py)."""
    from bin_tpu_torch.data.video import extract_cli
    extract_cli(argv)


def export_main(argv: list[str] | None = None) -> None:
    """Export a training checkpoint as a released-weights ``.npz`` with its
    card."""
    from bin_tpu_torch.training.checkpoint import restore_params
    from bin_tpu_torch.weights import export_weights

    cfg, args = parse_config(
        argv, "export", "Export released weights from a checkpoint.", {
            "--checkpoint": dict(required=True, help="checkpoint directory"),
            "--out": dict(required=True, help="output .npz weights file"),
            "--note": dict(default="", help="free-form metadata note"),
            "--ema": dict(action="store_true",
                          help="export the EMA params (optim.ema_decay runs)"),
            "--store-dtype": dict(default=None, metavar="DTYPE",
                                  help="storage dtype of the float leaves "
                                       "(float16 halves the file; "
                                       "load_weights restores float32)"),
            "--eval-json": dict(action="append", default=[], metavar="PATH",
                                help="eval record(s) ({'model': {...}, "
                                     "'protocol': {...}}) folded into the "
                                     "card; the first sets psnr_overall, "
                                     "ssim_overall and eval_protocol"),
        })
    params = restore_params(args.checkpoint, ema=args.ema)
    metadata = {"preset": cfg.preset, "note": args.note,
                **({"ema": True} if args.ema else {})}
    evals = []
    for path in args.eval_json:
        with open(path) as f:
            evals.append(json.load(f))
    if evals:
        head = evals[0]
        metadata.update(
            psnr_overall=head["model"]["psnr_overall"],
            ssim_overall=head["model"]["ssim_overall"],
            eval_protocol=head["protocol"], evals=evals)
    export_weights(args.out, params, cfg.model, metadata=metadata,
                   store_dtype=args.store_dtype)
    print(json.dumps({"out": args.out, "preset": cfg.preset,
                      "ema": args.ema,
                      "psnr_overall": metadata.get("psnr_overall")}),
          flush=True)


def _validate_and_stack(frames: list, what: str, model_cfg):
    """(1, K, H, W, 3) of a clip's frames, after the checks of
    ``bin_tpu``'s demo: enough frames, one size, and a size the stem's
    space-to-depth and the encoder's 2x downsamples divide."""
    import numpy as np

    if len(frames) < model_cfg.window_size:
        raise SystemExit(f"need >= {model_cfg.window_size} frames, "
                         f"got {len(frames)} from {what}")
    shapes = {f.shape for f in frames}
    if len(shapes) != 1:
        raise SystemExit(
            f"input frames of {what} have differing sizes: "
            + ", ".join(sorted(f"{s[0]}x{s[1]}" for s in shapes))
            + " — resize them to a common resolution first")
    h, w = frames[0].shape[:2]
    down = 2 ** (len(model_cfg.channel_mult) - 1)
    div = model_cfg.stem_factor * down
    if h % div or w % div:
        raise SystemExit(
            f"frame size {h}x{w} not divisible by {div} (stem_factor "
            f"{model_cfg.stem_factor} x {down} encoder downsample) — "
            f"crop/resize to multiples of {div}, e.g. "
            f"{h - h % div}x{w - w % div}")
    return np.stack(frames)[None]


def demo_main(argv: list[str] | None = None) -> None:
    """Joint deblur + 2x interpolation of a blurry frame folder, a blurry
    video or a synthetic clip with released weights; the output frames
    are written as PNGs (which needs PIL)."""
    import numpy as np
    import torch

    from bin_tpu_torch.data.video import VIDEO_EXTS
    from bin_tpu_torch.evaluation.evaluator import save_clip_frames
    from bin_tpu_torch.registry import build_model
    from bin_tpu_torch.weights import load_weights

    p = argparse.ArgumentParser(prog="python -m bin_tpu_torch.cli demo",
                                description=demo_main.__doc__)
    p.add_argument("--weights", required=True, help=".npz from export")
    p.add_argument("--input", default="synthetic",
                   help="folder of blurry key-frame images or .npy, a "
                        "blurry video file, or 'synthetic'")
    p.add_argument("--out", default="demo_out", help="output PNG folder")
    p.add_argument("--size", type=int, nargs=2, default=(256, 256),
                   metavar=("H", "W"), help="synthetic input size")
    p.add_argument("--keys", type=int, default=10, help="synthetic clip keys")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    args = p.parse_args(argv)

    params, model_cfg, meta = load_weights(args.weights)
    model = build_model(model_cfg, args.device).load_params(params)
    print(f"loaded {args.weights}: preset={meta.get('preset', '?')} "
          f"model={model_cfg.name}", flush=True)
    if args.input == "synthetic":
        from bin_tpu_torch.data.synthetic import make_sample
        h, w = args.size
        blurry = make_sample(seed=7, num_keys=args.keys, height=h, width=w,
                             style="textured")["blurry"][None]
    elif args.input.lower().endswith(VIDEO_EXTS):
        from bin_tpu_torch.data.video import iter_video_frames
        blurry = _validate_and_stack(
            [f.astype(np.float32) / 255.0
             for f in iter_video_frames(args.input)], args.input, model_cfg)
    else:
        from bin_tpu_torch.data.frames import load_frame
        paths = sorted(os.path.join(args.input, f)
                       for f in os.listdir(args.input)
                       if f.lower().endswith((".png", ".jpg", ".npy")))
        blurry = _validate_and_stack([load_frame(f) for f in paths],
                                     args.input, model_cfg)
    video, times = model.infer_clip(torch.from_numpy(blurry))
    save_clip_frames(video[0].cpu().numpy(), times, args.out, "demo")
    print(f"wrote {video.shape[1]} sharp frames (2x rate, times "
          f"{int(times[0])}..{int(times[-1])}) under {args.out}/demo/",
          flush=True)


def import_torch_main(argv: list[str] | None = None) -> None:
    """A PyTorch checkpoint to released weights (import_torch.py)."""
    from bin_tpu_torch.import_torch import import_cli
    import_cli(argv)


COMMANDS = {"train": train_main, "eval": eval_main, "bench": bench_main,
            "prep": prep_main, "extract": extract_main,
            "export": export_main, "demo": demo_main,
            "import-torch": import_torch_main}


def main(argv: list[str] | None = None) -> None:
    argv = sys.argv[1:] if argv is None else list(argv)
    if not argv or argv[0] not in COMMANDS:
        raise SystemExit("usage: python -m bin_tpu_torch.cli {"
                         + ",".join(COMMANDS) + "} [arguments]; "
                         "<command> --help for its arguments")
    from bin_tpu_torch.parallel.distributed import shutdown

    try:
        COMMANDS[argv[0]](argv[1:])
    finally:
        shutdown()


if __name__ == "__main__":
    main()
