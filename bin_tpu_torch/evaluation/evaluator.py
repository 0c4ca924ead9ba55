"""Full-clip evaluation: sliding-window inference + PSNR/SSIM tables
(``bin_tpu/evaluation/evaluator.py``).

Per clip: ``infer_clip`` of the blurry keys, the output clipped to [0, 1]
in fp32, PSNR and SSIM per output frame against the sharp ground truth at
the same timestamps, on the model's device; only the per-clip means cross
to the host.  Tables split deblurred key frames (even output timestamps)
from interpolated midpoints (odd timestamps), as the papers report them.

    python -m bin_tpu_torch.evaluation.evaluator --weights weights/prf_ema_r4.npz \\
        --set model.dtype=bfloat16 [--serving] [--num-clips N] [--self-ensemble] \\
        [--save-dir D] [--device cuda|cpu]

prints the protocol line and a row per clip on stderr and one JSON line of
the results on stdout.  The protocol is ``DataConfig``'s, by default the
release card's (256x256, 16 clips of 12 keys, seed 9999, textured);
``--set data.KEY=V`` changes it and the line flags it OFF-PROTOCOL.

``python -m bin_tpu_torch.cli eval --preset P`` runs ``evaluate_cli`` as
``bin_tpu``'s ``bin-tpu-eval`` does: a preset's protocol (its
``eval_size``), a checkpoint of the port's trainer or a release ``.npz``,
and, with ``data.root``, the clips of a frame-folder tree, whole with
``data.eval_num_keys=0``.  Started by ``torchrun``, it deals the clips over
the ranks and reduces their metrics in the one-process order, so the
result is the one-process result to the last bit.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import sys
from typing import Iterable

import numpy as np
import torch

from bin_tpu_torch.config import Config, DataConfig
from bin_tpu_torch.metrics import psnr, ssim
from bin_tpu_torch.models import recurrent
from bin_tpu_torch.models.pyramid import total_levels
from bin_tpu_torch.parallel import MeshPlan, make_mesh, maybe_initialize
from bin_tpu_torch.parallel.distributed import local_device
from bin_tpu_torch.registry import Model, build_model

__all__ = ["evaluate", "evaluate_cli", "clip_metrics_fn", "save_clip_frames",
           "ClipShare", "main"]


def _log(*args) -> None:
    print(*args, file=sys.stderr, flush=True)


def clip_metrics_fn(model: Model, num_keys: int, return_video: bool = False,
                    self_ensemble: bool = False):
    """(blurry, sharp) -> per-category (psnr, ssim) means, and the output
    timestamps.

    ``blurry`` (B, K, H, W, 3) and ``sharp`` (B, 2K-1, H, W, 3), numpy or
    tensors; the function returns {"psnr"|"ssim": {"interp"|"deblur"|
    "overall": (B,) tensor}}, with the assembled (B, T, H, W, 3) clip beside
    it when ``return_video``.  fp32 after the model (the 0.05 dB quality
    budget).

    ``self_ensemble``: test-time augmentation over the 4 spatial flips
    (none / H / W / both): infer each flipped clip, unflip, average in
    fp32.  Temporal reversal is excluded: the ConvLSTM recurrence is
    causal.  Results are not comparable with plain evals; callers record
    the flag."""
    plan = recurrent.assembly_plan(num_keys, model.cfg.window_size,
                                   total_levels(model.cfg))
    times = np.asarray(sorted(plan))
    interp_mask = torch.as_tensor(times % 2 == 1, device=model.device).float()
    gt_index = torch.as_tensor(times, device=model.device)

    def infer(blurry: torch.Tensor) -> torch.Tensor:
        if not self_ensemble:
            return model.infer_clip(blurry)[0]
        acc = None
        for flip_h in (False, True):
            for flip_w in (False, True):
                dims = [d for d, on in ((2, flip_h), (3, flip_w)) if on]
                x = blurry.flip(dims) if dims else blurry
                v = model.infer_clip(x)[0].float()
                if dims:
                    v = v.flip(dims)
                acc = v if acc is None else acc + v
        return acc / 4.0

    def split(x: torch.Tensor) -> dict[str, torch.Tensor]:
        interp = (x * interp_mask).sum(dim=1) / interp_mask.sum()
        n_deblur = x.shape[1] - interp_mask.sum()
        deblur = torch.where(
            n_deblur > 0,
            (x * (1 - interp_mask)).sum(dim=1) / n_deblur.clamp_min(1),
            torch.full_like(interp, math.nan))
        return {"interp": interp, "deblur": deblur, "overall": x.mean(dim=1)}

    @torch.inference_mode()
    def fn(blurry, sharp):
        blurry = torch.as_tensor(blurry, device=model.device)
        sharp = torch.as_tensor(sharp, device=model.device)
        video = infer(blurry).float().clamp(0.0, 1.0)
        gt = sharp[:, gt_index]
        out = {"psnr": split(psnr(video, gt)), "ssim": split(ssim(video, gt))}
        return (out, video) if return_video else out

    return fn, times


def save_clip_frames(video: np.ndarray, times: np.ndarray, out_dir: str,
                     clip_name: str) -> None:
    """Write assembled output frames as PNGs: <out_dir>/<clip>/t<t>.png on
    the 2x output grid.  Needs PIL, imported only here."""
    from bin_tpu_torch.data.frames import pil_image

    image = pil_image()
    d = os.path.join(out_dir, clip_name)
    os.makedirs(d, exist_ok=True)
    for frame, t in zip(video, times):
        arr = (np.clip(frame, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
        image.fromarray(arr).save(os.path.join(d, f"t{int(t):06d}.png"))


class ClipShare:
    """The samples ``plan.rank``, ``plan.rank + n``, ... of ``source``
    (of its first ``limit``, where given): one rank's share of the clips
    of an eval over ``n`` ranks, as a source."""

    def __init__(self, source, plan: MeshPlan, limit: int | None = None):
        self.source = source
        total = len(source) if limit is None else min(limit, len(source))
        self.indices = range(plan.rank, total, plan.num_data)

    def __len__(self) -> int:
        return len(self.indices)

    def __getitem__(self, i: int) -> dict[str, np.ndarray]:
        return self.source[self.indices[i]]

    def sample_name(self, i: int) -> str:
        if hasattr(self.source, "sample_name"):
            return self.source.sample_name(self.indices[i])
        return f"clip{self.indices[i]:04d}"


def _in_order(per_rank: list[list]) -> list:
    """The ranks' per-clip rows back in the one-process order: rank r's
    i-th row is clip r + i * n."""
    n = len(per_rank)
    total = sum(map(len, per_rank))
    return [per_rank[g % n][g // n] for g in range(total)]


def evaluate(model: Model, clips: Iterable[dict[str, np.ndarray]],
             verbose: bool = True, save_dir: str = "",
             self_ensemble: bool = False,
             plan: MeshPlan | None = None) -> dict[str, float]:
    """Aggregate PSNR/SSIM over eval clips.

    clips yield {"blurry": (B,K,H,W,3), "sharp": (B,2K-1,H,W,3),
    "valid": (B,) optional padding mask, "names": optional}.  With
    ``save_dir``, assembled output videos are also written as PNG frame
    folders.  With a ``plan`` of n ranks, ``clips`` are this rank's share,
    the clips of ``eval_clips(ClipShare(source, plan))`` (one clip a
    batch): the per-clip metrics of every rank are gathered and summed in
    the one-process order, and every rank returns the same result."""
    plan = plan or MeshPlan()
    fns: dict[int, tuple] = {}  # by clip length
    rows = []
    for ci, clip in enumerate(clips):
        num_keys = clip["blurry"].shape[1]
        if num_keys not in fns:
            fns[num_keys] = clip_metrics_fn(model, num_keys,
                                            return_video=bool(save_dir),
                                            self_ensemble=self_ensemble)
        fn, times = fns[num_keys]
        out = fn(clip["blurry"], clip["sharp"])
        valid = clip.get("valid", np.ones(clip["blurry"].shape[0], bool))
        names = clip.get("names") or [f"clip{ci:04d}_{bi}"
                                      for bi in range(clip["blurry"].shape[0])]
        names = [str(n).replace("/", "_") for n in names]
        if save_dir:
            out, video = out
            for bi in np.nonzero(valid)[0]:
                save_clip_frames(video[bi].cpu().numpy(), times, save_dir,
                                 names[bi])
        out = {m: {c: v.cpu().numpy() for c, v in cats.items()}
               for m, cats in out.items()}
        rows.append((out, valid, names))
    sums: dict[str, float] = {}
    count = 0
    for out, valid, names in _in_order(plan.gather(rows)):
        for metric, cats in out.items():
            for cat, vals in cats.items():
                vals = vals[valid]
                vals = vals[np.isfinite(vals)]  # NaN = category absent (e.g.
                if vals.size:                   # no deblur outputs at 1 level)
                    sums[f"{metric}_{cat}"] = (
                        sums.get(f"{metric}_{cat}", 0.0) + vals.sum())
        count += int(valid.sum())
        if verbose and plan.is_main:
            # per-video rows, as the reference's eval table prints them
            for bi in np.nonzero(valid)[0]:
                row = {f"{m}_{c}": float(v[bi])
                       for m, cs in out.items() for c, v in cs.items()}
                _log(f"  {names[bi]}: " + "  ".join(
                    f"{k}={v:.3f}" for k, v in row.items() if np.isfinite(v)))
    results = {k: float(v) / max(count, 1) for k, v in sums.items()}
    if verbose and results and plan.is_main:
        _log("== mean over {} clips ==".format(count))
        for k in sorted(results):
            _log(f"  {k}: {results[k]:.4f}")
    return results


def protocol_source(cfg: Config, num_clips: int | None = None):
    """(protocol dict, source) of ``cfg.data``'s eval protocol
    (``bin_tpu/evaluation/evaluator.py`` ``evaluate_cli``).

    Synthetic: ``num_clips`` clips of ``max(eval_num_keys, window + 2)``
    keys from the ``eval_seed`` stream.  With a folder dataset
    (``data.root`` and a ``data.dataset`` other than synthetic): every
    chunk of that many keys of the tree's clips (``data.eval_list``), or
    with ``eval_num_keys=0`` every whole clip, resized to ``eval_size``
    where the frames have another size.  Whole clips without a folder
    dataset raise."""
    d = cfg.data
    h, w = d.eval_size
    num_clips = d.eval_num_clips if num_clips is None else num_clips
    if num_clips <= 0:
        raise ValueError(f"num_clips must be positive, got {num_clips}")
    folder = d.dataset != "synthetic" and bool(d.root)
    if d.eval_num_keys == 0 and not folder:
        raise ValueError(
            "data.eval_num_keys=0 (whole clips) needs a folder dataset: "
            "set data.root (and data.dataset != 'synthetic')")
    num_keys = (None if d.eval_num_keys == 0 else
                max(d.eval_num_keys, cfg.model.window_size + 2))
    protocol = {"size": [h, w], "clips": num_clips,
                "keys": "whole" if num_keys is None else num_keys,
                "seed": d.eval_seed}
    if folder:
        from bin_tpu_torch.data.frames import FrameFolderSource

        source = FrameFolderSource(d.root, num_keys=num_keys,
                                   resize_to=(h, w), clip_list=d.eval_list)
        protocol.update(root=d.root, eval_list=d.eval_list,
                        samples=len(source))
    else:
        from bin_tpu_torch.data import SyntheticSource

        source = SyntheticSource(num_samples=num_clips, num_keys=num_keys,
                                 height=h, width=w, taps=d.blur_taps,
                                 stride=d.blur_stride, seed=d.eval_seed,
                                 style=d.synthetic_style)
        protocol.update(style=d.synthetic_style, taps=d.blur_taps,
                        stride=d.blur_stride)
    return protocol, source


def off_protocol(cfg: Config, num_clips: int) -> list[str]:
    """The protocol fields in which this eval departs from the pinned one
    (``DataConfig``'s defaults)."""
    pinned = DataConfig()
    off = ["num_clips"] if num_clips != cfg.data.eval_num_clips else []
    return off + [f.name for f in dataclasses.fields(DataConfig)
                  if getattr(cfg.data, f.name) != getattr(pinned, f.name)]


def preset_off_protocol(cfg: Config, num_clips: int) -> list[str]:
    """``bin_tpu``'s flags: the clip count against ``data.eval_num_clips``
    and the size against the preset's own ``eval_size``."""
    from bin_tpu_torch.config import get_config, PRESETS

    off = ["num_clips"] if num_clips != cfg.data.eval_num_clips else []
    if (cfg.preset in PRESETS and tuple(cfg.data.eval_size)
            != get_config(cfg.preset).data.eval_size):
        off.append("eval_size")
    return off


def evaluate_cli(cfg: Config, checkpoint: str = "",
                 num_clips: int | None = None, save_dir: str = "",
                 ema: bool = False, self_ensemble: bool = False,
                 device: torch.device | str = "cuda", verbose: bool = True,
                 pinned: bool = False) -> dict:
    """Evaluate ``checkpoint`` (a checkpoint directory of the port's
    trainer, its EMA with ``ema``, or a release ``.npz``), run as
    ``cfg.model``, under the protocol of ``cfg.data`` (``protocol_source``).
    Without a checkpoint it warns and evaluates a random init
    (``Model.init(cfg.seed)``).  The protocol line goes to stderr, flagged
    OFF-PROTOCOL against the preset's eval size as ``bin_tpu``'s, or with
    ``pinned`` against ``DataConfig()``'s pinned protocol.  On ``device``:
    CUDA unless the caller asks for the CPU; without a card it raises.
    Under ``torchrun`` each rank evaluates its share of the clips
    (``ClipShare``) and every rank returns the whole eval's result."""
    from bin_tpu_torch.data import eval_clips
    from bin_tpu_torch.training.checkpoint import restore_params

    maybe_initialize(device)
    device = local_device(device)
    plan = make_mesh(cfg.parallel)
    model = build_model(cfg.model, device)
    if checkpoint:
        params = restore_params(checkpoint, ema=ema)
    else:
        _log("WARNING: no checkpoint given — evaluating RANDOM INIT weights")
        params = model.init(cfg.seed)
    model.load_params(params)
    protocol, source = protocol_source(cfg, num_clips)
    h, w = protocol["size"]
    off = (off_protocol if pinned else preset_off_protocol)(
        cfg, protocol["clips"])
    if plan.is_main:
        _log(f"eval protocol: preset={cfg.preset} size={h}x{w} "
             f"clips={protocol['clips']} keys={protocol['keys']} "
             f"seed={protocol['seed']} dtype={cfg.model.dtype}"
             + (" self_ensemble=x4" if self_ensemble else "")
             + (f" [OFF-PROTOCOL: {','.join(off)}]" if off else ""))
    return evaluate(model, eval_clips(ClipShare(source, plan)),
                    verbose=verbose, save_dir=save_dir,
                    self_ensemble=self_ensemble, plan=plan)


def main(argv: list[str] | None = None) -> None:
    from bin_tpu_torch.benchmark import (SERVING_MODE, check_sidecar,
                                         mode_of, serving_overrides)
    from bin_tpu_torch.config import apply_overrides
    from bin_tpu_torch.weights import card_config

    p = argparse.ArgumentParser(
        description="Evaluate released weights on the pinned protocol.")
    p.add_argument("--weights", required=True, help=".npz release file")
    p.add_argument("--set", dest="overrides", action="append", default=[],
                   metavar="KEY=VALUE",
                   help="model.KEY=V (deployment knob over the card's "
                        "config) or data.KEY=V (protocol); repeatable")
    p.add_argument("--serving", action="store_true",
                   help="score the int8 serving mode that bench_torch.py "
                        "times (SERVING_MODE and its overrides), before "
                        "--set")
    p.add_argument("--num-clips", type=int, default=None)
    p.add_argument("--self-ensemble", action="store_true",
                   help="x4 flip test-time augmentation (off-protocol)")
    p.add_argument("--save-dir", default="",
                   help="write the output frames as PNGs here (needs PIL)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu (the plain versions)")
    args = p.parse_args(argv)

    card_model, meta = card_config(args.weights)
    overrides = ([*SERVING_MODE, *serving_overrides(args.weights)]
                 if args.serving else []) + args.overrides
    cfg = apply_overrides(
        Config(model=card_model, preset=meta.get("preset", "custom")),
        overrides)
    check_sidecar(cfg.model, args.weights)
    results = evaluate_cli(cfg, args.weights, num_clips=args.num_clips,
                           save_dir=args.save_dir,
                           self_ensemble=args.self_ensemble,
                           device=args.device, pinned=True)
    protocol, _ = protocol_source(cfg, args.num_clips)
    protocol["dtype"] = cfg.model.dtype
    if args.self_ensemble:
        protocol["self_ensemble"] = 4
    device = torch.device(args.device)
    print(json.dumps({
        "weights": args.weights,
        "mode": mode_of(cfg.model, card_model, args.weights),
        "overrides": overrides, "protocol": protocol,
        "off_protocol": off_protocol(cfg, protocol["clips"]),
        "card_psnr_overall": meta.get("psnr_overall"),
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu"),
        **results}), flush=True)


if __name__ == "__main__":
    main()
