#!/usr/bin/env python3
"""Why the card's training gradient differs from the CPU's where it does.

    python3 tools/train_grad_check.py [--seeds 1 2 3] [--card-runs 2]
        [--eps 1e-6 1e-3] [--set KEY=VALUE ...] [--out PATH]

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
once more with every LeakyReLU's side (and under QAT every activation's
quantized value and scale) pinned to the first CPU run's
(``chip_smoke.kink_record``).
``--set`` changes the config (``--set model.conv_int8_qat=true --set
model.conv_int8_min_cin=256`` is ``chip_smoke.py`` phase ``int8_release``'s
QAT check); under QAT it also counts the activations whose quantized value
``round(x / s)`` moves, by module, as a kink of its own.  Prints one JSON
line per (eps, seed) and a summary line with each leaf's largest sound
reading (the CPU's own spread and the card with TF32 off) beside its
smallest control reading (TF32 on), and the same two over the pinned runs
(the control pinned too); ``--out`` also writes every leaf's readings.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

SCALE = 1 + 1e-7
# the runs whose readings are sound: the CPU's own spread, the card's with
# TF32 off (not the control, nor the runs with the kinks pinned)
SOUND = ("cpu_scaled", "card_0", "card_1")
# the sound runs with every kink pinned to the first CPU run's (their
# control: card_tf32_pinned)
PINNED = ("cpu_scaled_pinned", "card_pinned")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[1, 2, 3])
    ap.add_argument("--card-runs", type=int, default=2)
    ap.add_argument("--eps", type=float, nargs="+", default=[1e-6, 1e-3])
    ap.add_argument("--set", action="append", default=[],
                    metavar="KEY=VALUE", help="config override")
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
    base = get_config("config3_prf", [*smoke.TRAIN_SETS, *args.set])
    rows, sound_max, control_min = [], {}, {}
    pinned_max, pinned_control_min = {}, {}
    for eps in args.eps:
        cfg = dataclasses.replace(base, loss=dataclasses.replace(
            base.loss, charbonnier_eps=eps))
        for seed in args.seeds:
            blurry, sharp = smoke.train_clip(torch, seed)
            rec = {k: {"diff": [], "leaky": []}
                   for k in ("cpu", "cpu_scaled", "card_0")}
            scaled = blurry * SCALE
            with smoke.kink_record(rec["cpu"]):
                cpu = smoke.clip_grads(torch, params, cfg, "cpu", blurry,
                                       sharp)
            with smoke.kink_record(rec["cpu_scaled"]):
                runs = {"cpu_scaled": smoke.clip_grads(
                    torch, params, cfg, "cpu", scaled, sharp)}
            for i in range(args.card_runs):
                with smoke.kink_record(rec["card_0"]) if i == 0 else \
                        contextlib.nullcontext():
                    runs[f"card_{i}"] = smoke.clip_grads(
                        torch, params, cfg, "cuda", blurry, sharp)
            runs["card_tf32"] = smoke.clip_grads(
                torch, params, cfg, "cuda", blurry, sharp, tf32=True)
            for key, dev, x, tf32 in [
                    ("cpu_scaled_pinned", "cpu", scaled, False),
                    ("card_pinned", "cuda", blurry, False),
                    ("card_tf32_pinned", "cuda", blurry, True)]:
                with smoke.kink_record({"diff": [], "leaky": []},
                                       pin=rec["cpu"]):
                    runs[key] = smoke.clip_grads(torch, params, cfg, dev, x,
                                                 sharp, tf32=tf32)
            readings = {k: smoke.grad_readings(torch, r, cpu)
                        for k, r in runs.items()}
            norms = {n: g.norm().item() for n, g in cpu["grads"].items()}
            row = {"eps": eps, "seed": seed,
                   "kinks_cpu_scaled": smoke.kink_switches(
                       torch, rec["cpu"], rec["cpu_scaled"]),
                   "kinks_card": smoke.kink_switches(torch, rec["cpu"],
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
                    pinned_max[n] = max(pinned_max.get(n, 0.0), *(
                        readings[k]["leaves"][n] for k in PINNED))
                    pinned_control_min[n] = min(
                        pinned_control_min.get(n, 1e9),
                        readings["card_tf32_pinned"]["leaves"][n])
    over = sorted((n for n in sound_max if sound_max[n] > 1e-3),
                  key=lambda n: -sound_max[n])
    print(json.dumps({
        "card": card, "torch": torch.__version__, "seeds": args.seeds,
        "eps": base.loss.charbonnier_eps, "sets": args.set,
        "sound_max_over_1e-3": {n: sound_max[n] for n in over},
        "control_min_of_those": {n: control_min[n] for n in over},
        "control_min_all_leaves": min(control_min.values()),
        "sound_max_all_leaves": max(sound_max.values()),
        "pinned_max_all_leaves": max(pinned_max.values()),
        "pinned_control_min_all_leaves": min(pinned_control_min.values())}),
        flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"card": card, "rows": rows}, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
