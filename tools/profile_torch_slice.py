#!/usr/bin/env python3
"""Where the time of the port's main paths goes on the card.

    python3 tools/profile_torch_slice.py [--mode bf16|serving|train]
        [--runs 2] [--table PATH]

``bf16`` and ``serving`` run ``infer_clip`` of the released weights on a
(1, 8, 720, 1280, 3) clip made from seed 0 (as ``chip_smoke.py``), in bf16
or in the int8 serving mode that ``bench_torch.py`` times; ``train`` runs
config3_prf's train step at full width (batch 4, 128x128 crops, 6 keys,
fp32, EMA 0.999, as ``chip_smoke.py`` phase ``train``) warm-started from
the released weights, on one u8 batch made from seed 0.  Each mode warms
up, times ``--runs`` clips or steps without the profiler (CUDA events),
then ``--runs`` more under ``torch.profiler``.  Prints one JSON line: the
wall time per clip or step with and without the profiler, the device's
busy time (the sum of its kernels) and its idle share against each wall,
the kernel launches, the device time and launches by kernel group
(convolutions forward and backward, K3 and K3q, the port's other kernels,
the rest) with the top kernels by name, and the eager elementwise passes a
conv's epilogue can take (PyTorch's LeakyReLU and add kernels); ``--table``
writes the profiler's full table to a file.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

CLIP = (1, 8, 720, 1280, 3)
PORT_KERNELS = ("lstm_gates", "s2d_pack")
INT8_KERNELS = {"int8_conv_kernel": "int8_conv (K3)",
                "quantize_act_kernel": "quantize_act (K3q)"}
CONV_MARKS = ("conv", "xmma", "cutlass", "implicit", "gemm", "fprop",
              "dgrad", "wgrad", "cudnn", "sm90_")
# PyTorch's elementwise kernels of the passes after a conv: the LeakyReLU;
# the adds (the residual and skip adds, and the float convs' bias adds)
PASSES = {"leaky_relu": ("leaky_relu",), "add": ("_add<",)}


def group(name: str) -> str:
    low = name.lower()
    for k, g in INT8_KERNELS.items():
        if k in name:
            return g
    if any(k in name for k in PORT_KERNELS):
        return "port_kernels"
    if any(m in low for m in CONV_MARKS):
        return "convolutions"
    return "other"


def inference_run(torch, mode: str):
    """``infer_clip`` of the released weights on the seed-0 clip."""
    import numpy as np

    from bin_tpu_torch import build_model
    from bin_tpu_torch.benchmark import (SERVING_MODE, WEIGHTS,
                                         serving_overrides)
    from bin_tpu_torch.config import apply_model_overrides
    from bin_tpu_torch.weights import load_weights

    params, cfg, _ = load_weights(os.path.join(REPO, WEIGHTS))
    cfg = dataclasses.replace(cfg, dtype="bfloat16")
    if mode == "serving":
        cfg = apply_model_overrides(cfg, [*SERVING_MODE,
                                          *serving_overrides(WEIGHTS)])
    model = build_model(cfg, "cuda").load_params(params)
    clip = torch.from_numpy(np.random.default_rng(0).uniform(
        0, 1, CLIP).astype(np.float32)).cuda()
    return (lambda: model.infer_clip(clip)), {"clip": list(CLIP)}


def train_run(torch):
    """One config3_prf train step on the seed-0 u8 batch; the state carries
    from step to step."""
    import numpy as np

    from bin_tpu_torch import build_model
    from bin_tpu_torch.config import get_config
    from bin_tpu_torch.training.state import create_train_state, warm_start
    from bin_tpu_torch.training.trainer import make_train_step
    from bin_tpu_torch.weights import load_weights

    cfg = get_config("config3_prf", ["optim.ema_decay=0.999"])
    params, _, _ = load_weights(os.path.join(REPO, "weights",
                                             "prf_ema_r4.npz"))
    model = build_model(cfg.model, "cuda")
    state = [warm_start(create_train_state(cfg, model), params)]
    b, k, (h, w) = cfg.data.batch_size, cfg.data.seq_len, cfg.data.crop_size
    rng = np.random.default_rng(0)
    batch = {"blurry": rng.integers(0, 256, (b, k, h, w, 3), np.uint8),
             "sharp": rng.integers(0, 256, (b, 2 * k - 1, h, w, 3), np.uint8)}
    batch = {key: torch.from_numpy(v).cuda() for key, v in batch.items()}
    step = make_train_step(model, cfg)

    def run():
        state[0], _ = step(state[0], batch)
    return run, {"preset": cfg.preset, "batch": b, "seq_len": k,
                 "crop": [h, w],
                 "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mode", choices=("bf16", "serving", "train"),
                    default="bf16")
    ap.add_argument("--runs", type=int, default=2,
                    help="clips or steps timed, and again profiled")
    ap.add_argument("--table", help="write the full profiler table here")
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_torch_slice: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    if args.mode == "train":
        run, info = train_run(torch)
        unit, warm = "step", 3
    else:
        run, info = inference_run(torch, args.mode)
        unit, warm = "clip", 1
    for _ in range(warm):
        run()
    torch.cuda.synchronize()

    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    for _ in range(args.runs):
        run()
    ev[1].record()
    torch.cuda.synchronize()
    wall_ms = ev[0].elapsed_time(ev[1]) / args.runs

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.runs):
            run()
        torch.cuda.synchronize()
        profiled_ms = (time.perf_counter() - t0) * 1e3 / args.runs

    kernels = {}
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = evt.self_cuda_time_total
        kernels[evt.key] = (us / 1e3 / args.runs, evt.count / args.runs)
    busy = sum(ms for ms, _ in kernels.values())
    groups: dict[str, dict] = {}
    for name, (ms, n) in kernels.items():
        g = groups.setdefault(group(name), {f"ms_per_{unit}": 0.0,
                                            f"launches_per_{unit}": 0.0})
        g[f"ms_per_{unit}"] += ms
        g[f"launches_per_{unit}"] += n
    passes = {}
    for kind, marks in PASSES.items():
        hit = [v for n, v in kernels.items() if any(m in n for m in marks)]
        passes[kind] = {f"ms_per_{unit}": sum(ms for ms, _ in hit),
                        f"launches_per_{unit}": sum(c for _, c in hit)}
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:15]
    if args.table:
        os.makedirs(os.path.dirname(os.path.abspath(args.table)), exist_ok=True)
        with open(args.table, "w") as f:
            f.write(card + "\n")
            f.write(prof.key_averages().table(row_limit=80))
    print(json.dumps({
        "card": card, "mode": args.mode, **info, "runs": args.runs,
        f"wall_ms_per_{unit}": wall_ms,
        f"profiled_wall_ms_per_{unit}": profiled_ms,
        f"device_busy_ms_per_{unit}": busy,
        "device_idle_share": 1 - busy / wall_ms,
        "device_idle_share_profiled": 1 - busy / profiled_ms,
        f"launches_per_{unit}": sum(n for _, n in kernels.values()),
        "groups": groups, "passes": passes,
        "top_kernels": [{"name": n[:120], f"ms_per_{unit}": ms,
                         f"launches_per_{unit}": c}
                        for n, (ms, c) in top]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
