#!/usr/bin/env python3
"""Where the time of the port's main path goes on the card.

    python3 tools/profile_torch_slice.py [--mode bf16|serving] [--clips 2]
        [--table PATH]

Runs ``infer_clip`` of the released weights on a (1, 8, 720, 1280, 3) clip
made from seed 0 (as ``chip_smoke.py``), in bf16 or in the int8 serving
mode that ``bench_torch.py`` times, once to warm up, then ``--clips`` times
under ``torch.profiler``.  Prints one JSON line: the wall time per clip,
the device's busy time per clip (the sum of its kernels) and idle share,
the device time by kernel group (cuDNN's convolutions, K3 and K3q, the
port's other kernels, the rest) with the top kernels by name, and the
eager elementwise passes a conv's epilogue can take (PyTorch's LeakyReLU
and add kernels: ms and launches per clip); ``--table`` writes the
profiler's full table to a file.  Needs a CUDA device.
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
PORT_KERNELS = ("lstm_gates_kernel", "s2d_pack_kernel")
INT8_KERNELS = {"int8_conv_kernel": "int8_conv (K3)",
                "quantize_act_kernel": "quantize_act (K3q)"}
CONV_MARKS = ("conv", "xmma", "cutlass", "implicit", "gemm", "fprop", "cudnn")
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mode", choices=("bf16", "serving"), default="bf16")
    ap.add_argument("--clips", type=int, default=2)
    ap.add_argument("--table", help="write the full profiler table here")
    args = ap.parse_args()

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_torch_slice: no CUDA device", file=sys.stderr)
        return 1
    from bin_tpu_torch import build_model
    from bin_tpu_torch.benchmark import (SERVING_MODE, WEIGHTS,
                                         serving_overrides)
    from bin_tpu_torch.config import apply_model_overrides
    from bin_tpu_torch.weights import load_weights

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    params, cfg, _ = load_weights(os.path.join(REPO, WEIGHTS))
    cfg = dataclasses.replace(cfg, dtype="bfloat16")
    if args.mode == "serving":
        cfg = apply_model_overrides(cfg, [*SERVING_MODE,
                                          *serving_overrides(WEIGHTS)])
    model = build_model(cfg, "cuda").load_params(params)
    clip = torch.from_numpy(np.random.default_rng(0).uniform(
        0, 1, CLIP).astype(np.float32)).cuda()
    model.infer_clip(clip)
    torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.clips):
            model.infer_clip(clip)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / args.clips

    kernels = {}
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = evt.self_cuda_time_total
        kernels[evt.key] = (us / 1e3 / args.clips, evt.count // args.clips)
    busy = sum(ms for ms, _ in kernels.values())
    groups: dict[str, float] = {}
    for name, (ms, _) in kernels.items():
        groups[group(name)] = groups.get(group(name), 0.0) + ms
    passes = {}
    for kind, marks in PASSES.items():
        hit = [v for n, v in kernels.items() if any(m in n for m in marks)]
        passes[kind] = {"ms_per_clip": sum(ms for ms, _ in hit),
                        "launches_per_clip": sum(c for _, c in hit)}
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:12]
    if args.table:
        os.makedirs(os.path.dirname(os.path.abspath(args.table)), exist_ok=True)
        with open(args.table, "w") as f:
            f.write(card + "\n")
            f.write(prof.key_averages().table(row_limit=60))
    print(json.dumps({
        "card": card, "clip": list(CLIP), "mode": args.mode,
        "clips": args.clips, "wall_ms_per_clip": wall_ms,
        "device_busy_ms_per_clip": busy,
        "device_idle_share": 1 - busy / wall_ms if wall_ms else None,
        "group_ms_per_clip": groups, "passes": passes,
        "top_kernels": [{"name": n[:120], "ms_per_clip": ms, "launches": c}
                        for n, (ms, c) in top]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
