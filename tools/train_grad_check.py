#!/usr/bin/env python3
"""Why the card's training gradient differs from the CPU's where it does.

    python3 tools/train_grad_check.py [--seeds 1 2 3] [--card-runs 2]
        [--eps 1e-6 1e-3] [--out PATH]

For each Charbonnier ``eps`` (config3_prf's 1e-6, and a wider one that
smooths the loss's kink at zero) and each seed, takes the loss and the
gradient of one fixed clip at config3_prf's full width from the released
weights (batch 1, 128x128, 5 keys, as ``chip_smoke.py`` phase ``train``,
whose seed is 1) on the CPU, on the CPU with the clip scaled by 1 + 1e-7,
on the card with TF32 off ``--card-runs`` times, and on the card with TF32
on (the control), each against the first CPU run: the loss, all gradients
together and each leaf in relative L2.  Against the first CPU run it also
counts what switches side of a kink, in the scaled CPU run and in the
card's first: the loss terms' differences that change sign (and those
within 1e-5 of zero), and the LeakyReLU inputs that change sign, by the
model's top-level module; and it runs the scaled CPU clip and the card
once more with every LeakyReLU's side pinned to the first CPU run's.  Prints
one JSON line per (eps, seed) and a summary line with each leaf's largest
sound reading (the CPU's own spread and the card with TF32 off) beside
its smallest control reading (TF32 on); ``--out`` also writes every
leaf's readings.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
from unittest import mock

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

SCALE = 1 + 1e-7
# the runs whose readings are sound: the CPU's own spread, the card's with
# TF32 off (not the control, nor the runs with the kinks pinned)
SOUND = ("cpu_scaled", "card_0", "card_1")


@contextlib.contextmanager
def kink_record(record: dict, pin: list | None = None):
    """Records every Charbonnier difference and every LeakyReLU input's
    sign in call order, each sign with the model's top-level module that
    made it (``level_3``, ``lstm_2``, ...).  With ``pin`` (an earlier run's
    record), each LeakyReLU takes the slope of that run's side instead of
    its own: a kink's side is then the same in both runs."""
    import torch
    import torch.nn.functional as F

    import bin_tpu_torch
    from bin_tpu_torch import losses

    charb, leaky, build = losses.charbonnier, F.leaky_relu, \
        bin_tpu_torch.build_model
    names, where = {}, [""]

    def build_model(*args, **kw):
        model = build(*args, **kw)
        names.update({id(m): n for n, m in model.module.named_children()})
        return model

    def top_module(module, inputs):
        where[0] = names.get(id(module), where[0])

    def charbonnier(pred, target, eps=1e-6):
        record["diff"].append((pred.float() - target.float()).detach()
                              .flatten().cpu())
        return charb(pred, target, eps)

    def leaky_relu(x, slope=0.01, inplace=False):
        side = (x > 0).detach()
        record["leaky"].append((where[0], side.flatten().cpu()))
        if pin is None:
            return leaky(x, slope, inplace)
        side = pin[len(record["leaky"]) - 1][1].to(x.device).view_as(x)
        return torch.where(side, x, x * slope)

    hook = torch.nn.modules.module.register_module_forward_pre_hook(
        top_module)
    try:
        with mock.patch.object(losses, "charbonnier", charbonnier), \
                mock.patch.object(F, "leaky_relu", leaky_relu), \
                mock.patch.object(bin_tpu_torch, "build_model", build_model):
            yield
    finally:
        hook.remove()


def kink_switches(torch, a: dict, b: dict) -> dict:
    """What switched side of a kink between records ``a`` and ``b``."""
    diff_a, diff_b = torch.cat(a["diff"]), torch.cat(b["diff"])
    by_module: dict[str, int] = {}
    for (where, sa), (_, sb) in zip(a["leaky"], b["leaky"]):
        n = int((sa != sb).sum())
        if n:
            by_module[where] = by_module.get(where, 0) + n
    return {"loss_terms": diff_a.numel(),
            "loss_terms_within_1e-5": int((diff_a.abs() < 1e-5).sum()),
            "loss_terms_sign_switched": int(
                ((diff_a > 0) != (diff_b > 0)).sum()),
            "leaky_inputs": sum(s.numel() for _, s in a["leaky"]),
            "leaky_sign_switched": sum(by_module.values()),
            "leaky_sign_switched_by_module": by_module}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[1, 2, 3])
    ap.add_argument("--card-runs", type=int, default=2)
    ap.add_argument("--eps", type=float, nargs="+", default=[1e-6, 1e-3])
    ap.add_argument("--out", help="write every leaf's readings here")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("train_grad_check: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as smoke
    from bin_tpu_torch.config import get_config
    from bin_tpu_torch.weights import load_weights

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    params, _, _ = load_weights(smoke.WEIGHTS)
    base = get_config("config3_prf", smoke.TRAIN_SETS)
    rows, sound_max, control_min = [], {}, {}
    for eps in args.eps:
        cfg = dataclasses.replace(base, loss=dataclasses.replace(
            base.loss, charbonnier_eps=eps))
        for seed in args.seeds:
            blurry, sharp = smoke.train_clip(torch, seed)
            rec = {k: {"diff": [], "leaky": []}
                   for k in ("cpu", "cpu_scaled", "card_0")}
            scaled = blurry * SCALE
            with kink_record(rec["cpu"]):
                cpu = smoke.clip_grads(torch, params, cfg, "cpu", blurry,
                                       sharp)
            with kink_record(rec["cpu_scaled"]):
                runs = {"cpu_scaled": smoke.clip_grads(
                    torch, params, cfg, "cpu", scaled, sharp)}
            for i in range(args.card_runs):
                with kink_record(rec["card_0"]) if i == 0 else \
                        contextlib.nullcontext():
                    runs[f"card_{i}"] = smoke.clip_grads(
                        torch, params, cfg, "cuda", blurry, sharp)
            runs["card_tf32"] = smoke.clip_grads(
                torch, params, cfg, "cuda", blurry, sharp, tf32=True)
            for key, dev, x in [("cpu_scaled_pinned", "cpu", scaled),
                                ("card_pinned", "cuda", blurry)]:
                with kink_record({"diff": [], "leaky": []},
                                 pin=rec["cpu"]["leaky"]):
                    runs[key] = smoke.clip_grads(torch, params, cfg, dev, x,
                                                 sharp)
            readings = {k: smoke.grad_readings(torch, r, cpu)
                        for k, r in runs.items()}
            norms = {n: g.norm().item() for n, g in cpu["grads"].items()}
            row = {"eps": eps, "seed": seed,
                   "kinks_cpu_scaled": kink_switches(torch, rec["cpu"],
                                                     rec["cpu_scaled"]),
                   "kinks_card": kink_switches(torch, rec["cpu"],
                                               rec["card_0"]),
                   "whole": {k: {"loss_rel_diff": r["loss_rel_diff"],
                                 "grad_rel_l2": r["grad_rel_l2"]}
                             for k, r in readings.items()}}
            sound = {n: max(r["leaves"][n] for k, r in readings.items()
                            if k in SOUND) for n in norms}
            control = readings["card_tf32"]["leaves"]
            top = sorted(sound, key=lambda n: -sound[n])[:8]
            row["top_leaves"] = [
                {"leaf": n, "norm": norms[n], "sound_max": sound[n],
                 **{k: r["leaves"][n] for k, r in readings.items()}}
                for n in top]
            row["leaves_sound_over_1e-3"] = sum(v > 1e-3
                                                for v in sound.values())
            row["leaves_control_under_1e-3"] = sum(v <= 1e-3
                                                   for v in control.values())
            print(json.dumps(row), flush=True)
            rows.append({**row, "leaves": {
                n: {"norm": norms[n], **{k: r["leaves"][n]
                                         for k, r in readings.items()}}
                for n in norms}})
            if eps == base.loss.charbonnier_eps:
                for n in norms:
                    sound_max[n] = max(sound_max.get(n, 0.0), sound[n])
                    control_min[n] = min(control_min.get(n, 1e9), control[n])
    over = sorted((n for n in sound_max if sound_max[n] > 1e-3),
                  key=lambda n: -sound_max[n])
    print(json.dumps({
        "card": card, "torch": torch.__version__, "seeds": args.seeds,
        "eps": base.loss.charbonnier_eps,
        "sound_max_over_1e-3": {n: sound_max[n] for n in over},
        "control_min_of_those": {n: control_min[n] for n in over},
        "control_min_all_leaves": min(control_min.values()),
        "sound_max_all_leaves": max(sound_max.values())}), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"card": card, "rows": rows}, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
