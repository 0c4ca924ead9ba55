#!/usr/bin/env python3
"""Where the time of the port's main paths goes on the card.

    python3 tools/profile_torch_slice.py [--mode bf16|serving|train|qat|calib]
        [--set KEY=VALUE ...] [--runs 2] [--table PATH]

``bf16`` and ``serving`` run ``infer_clip`` of the released weights on a
(1, 8, 720, 1280, 3) clip made from seed 0 (as ``chip_smoke.py``), in bf16
or in the int8 serving mode that ``bench_torch.py`` times; ``train`` runs
config3_prf's train step at full width (batch 4, 128x128 crops, 6 keys,
fp32, EMA 0.999, as ``chip_smoke.py`` phase ``train``, with ``--set``
over it) warm-started from the released weights, on one u8 batch made
from seed 0.  ``qat`` is that step with ``tools/qat_finetune.sh``'s
settings (QAT at min_cin 256, bf16, remat, as ``chip_smoke.py`` phase
``int8_release``), profiled twice: as it is, and with every QAT conv's
fake quantizers taken out (the same convs on the unquantized fp32
values), so that the difference is what the quantizers cost a step.
``calib`` runs a calibration clip (12 keys at 256x256, as
``python -m bin_tpu_torch.calibrate``) in calibration mode and then in
plain bf16: the difference is what recording the abs-maxima costs.  Each
run warms up, times ``--runs`` clips or steps without the profiler (CUDA
events), then ``--runs`` more under ``torch.profiler``.  Prints one JSON
line: the wall time per clip or step with and without the profiler, the
device's busy time (the sum of its kernels) and its idle share against
each wall, the kernel launches, the device time and launches by kernel
group (convolutions forward and backward, K3 and K3q, the port's other
kernels, the rest) with the top kernels by name, and the eager
elementwise passes a conv's epilogue can take (PyTorch's LeakyReLU and add
kernels); ``qat`` and ``calib`` add the baseline's numbers and the
difference; ``train`` and ``qat`` add, from one more step, K1b's calls and
how many of them got a cotangent that its wrapper had to copy.
``--table`` writes the profiler's full table to a file.  Needs a CUDA
device.
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


# tools/qat_finetune.sh's step, as chip_smoke.py phase int8_release runs it
QAT_SETS = ["model.conv_int8_qat=true", "model.conv_int8_min_cin=256",
            "model.dtype=bfloat16", "model.remat=true",
            "optim.learning_rate=1e-5"]


def train_run(torch, sets: list[str]):
    """One config3_prf train step (``sets`` over the preset) on the seed-0
    u8 batch; the state carries from step to step."""
    import numpy as np

    from bin_tpu_torch import build_model
    from bin_tpu_torch.config import get_config
    from bin_tpu_torch.training.state import create_train_state, warm_start
    from bin_tpu_torch.training.trainer import make_train_step
    from bin_tpu_torch.weights import load_weights

    cfg = get_config("config3_prf", ["optim.ema_decay=0.999", *sets])
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
    return run, {"preset": cfg.preset, "sets": sets, "batch": b,
                 "seq_len": k, "crop": [h, w], "dtype": cfg.model.dtype,
                 "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32}


def without_fake_quant():
    """A context in which every QAT conv runs its conv on the unquantized
    fp32 values: the QAT step with the fake quantizers taken out."""
    from unittest import mock

    import torch
    import torch.nn.functional as F

    from bin_tpu_torch.ops import quant

    class Plain(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, weight, stride, pad):
            ctx.save_for_backward(x, weight)
            ctx.stride, ctx.pad = stride, pad
            acc = F.conv2d(quant._pad_nchw(x, stride, pad), weight, None,
                           stride)
            return acc.permute(0, 2, 3, 1)

        @staticmethod
        def backward(ctx, dy):
            x, weight = ctx.saved_tensors
            stride, (pt, pl) = ctx.stride, ctx.pad
            xp = quant._pad_nchw(x, stride, (pt, pl))
            dxp, dw, _ = torch.ops.aten.convolution_backward(
                dy.permute(0, 3, 1, 2), xp, weight, None, (stride, stride),
                (0, 0), (1, 1), False, (0, 0), 1, (True, True, False))
            h, w = x.shape[1:3]
            return (dxp[:, :, pt:pt + h, pl:pl + w].permute(0, 2, 3, 1), dw,
                    None, None)

    return mock.patch.object(quant, "_FakeQuantConv", Plain)


def calib_run(torch, calibrate: bool):
    """``infer_clip`` of a (1, 12, 256, 256, 3) seed-0 clip, in calibration
    mode (the abs-maxima recorded) or in plain bf16."""
    import numpy as np

    from bin_tpu_torch import build_model
    from bin_tpu_torch.config import apply_model_overrides
    from bin_tpu_torch.weights import load_weights

    params, cfg, _ = load_weights(os.path.join(REPO, "weights",
                                               "prf_ema_r4.npz"))
    cfg = apply_model_overrides(cfg, [
        "model.dtype=bfloat16", f"model.conv_int8_calibrate={calibrate}"])
    model = build_model(cfg, "cuda").load_params(params)
    clip = torch.from_numpy(np.random.default_rng(0).uniform(
        0, 1, (1, 12, 256, 256, 3)).astype(np.float32)).cuda()
    windows = clip.shape[1] - cfg.window_size + 1
    return (lambda: model.infer_clip(clip)), {
        "clip": list(clip.shape), "windows": windows,
        "recorded_inputs": len(model.module.quant_stats)}


def profiled(torch, run, runs: int, warm: int, unit: str,
             table: str | None = None, card: str = "") -> dict:
    """``run`` warmed up ``warm`` times, timed ``runs`` times by CUDA
    events, then ``runs`` times under the profiler: the numbers described
    at the top."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warm):
        run()
    torch.cuda.synchronize()

    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    for _ in range(runs):
        run()
    ev[1].record()
    torch.cuda.synchronize()
    wall_ms = ev[0].elapsed_time(ev[1]) / runs

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(runs):
            run()
        torch.cuda.synchronize()
        profiled_ms = (time.perf_counter() - t0) * 1e3 / runs

    kernels = {}
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = evt.self_cuda_time_total
        kernels[evt.key] = (us / 1e3 / runs, evt.count / runs)
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
    if table:
        os.makedirs(os.path.dirname(os.path.abspath(table)), exist_ok=True)
        with open(table, "w") as f:
            f.write(card + "\n")
            f.write(prof.key_averages().table(row_limit=80))
    return {
        f"wall_ms_per_{unit}": wall_ms,
        f"profiled_wall_ms_per_{unit}": profiled_ms,
        f"device_busy_ms_per_{unit}": busy,
        "device_idle_share": 1 - busy / wall_ms,
        "device_idle_share_profiled": 1 - busy / profiled_ms,
        f"launches_per_{unit}": sum(n for _, n in kernels.values()),
        "groups": groups, "passes": passes,
        "top_kernels": [{"name": n[:120], f"ms_per_{unit}": ms,
                         f"launches_per_{unit}": c}
                        for n, (ms, c) in top]}


def cotangent_copies(torch, run) -> dict:
    """One more step with ``FusedLSTMGates.backward`` watched: its calls
    (K1b's launches), and those whose ``dh`` or ``dc_out`` is not fp32 and
    contiguous, where its ``.float().contiguous()`` launches a copy."""
    from bin_tpu_torch.ops import lstm_gates

    fn = lstm_gates.FusedLSTMGates.backward
    dense = []

    def backward(ctx, dh, dc_out):
        dense.append(all(t.dtype == torch.float32 and t.is_contiguous()
                         for t in (dh, dc_out)))
        return fn(ctx, dh, dc_out)

    lstm_gates.FusedLSTMGates.backward = staticmethod(backward)
    try:
        run()
        torch.cuda.synchronize()
    finally:
        lstm_gates.FusedLSTMGates.backward = staticmethod(fn)
    return {"k1b_calls_per_step": len(dense),
            "cotangent_copies_per_step": dense.count(False)}


def difference(a: dict, b: dict, unit: str) -> dict:
    """``a`` less ``b`` in wall, device busy time and launches."""
    keys = (f"wall_ms_per_{unit}", f"device_busy_ms_per_{unit}",
            f"launches_per_{unit}")
    return {k: a[k] - b[k] for k in keys}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mode", choices=("bf16", "serving", "train", "qat",
                                       "calib"), default="bf16")
    ap.add_argument("--set", action="append", default=[],
                    metavar="KEY=VALUE",
                    help="config override of the train step (train, qat)")
    ap.add_argument("--runs", type=int, default=2,
                    help="clips or steps timed, and again profiled")
    ap.add_argument("--table", help="write the full profiler table here")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("profile_torch_slice: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    out = {"card": card, "mode": args.mode, "runs": args.runs}
    if args.mode in ("train", "qat"):
        sets = [*(QAT_SETS if args.mode == "qat" else []), *args.set]
        run, info = train_run(torch, sets)
        out.update(info)
        out.update(profiled(torch, run, args.runs, 3, "step", args.table,
                            card))
        out["k1b_cotangents"] = cotangent_copies(torch, run)
        if args.mode == "qat":
            with without_fake_quant():
                out["without_fake_quant"] = profiled(torch, run, args.runs,
                                                     3, "step")
            out["fake_quant"] = difference(out, out["without_fake_quant"],
                                           "step")
    elif args.mode == "calib":
        run, info = calib_run(torch, True)
        out.update(info)
        out.update(profiled(torch, run, args.runs, 1, "clip", args.table,
                            card))
        run, _ = calib_run(torch, False)
        out["bf16"] = profiled(torch, run, args.runs, 1, "clip")
        amax = difference(out, out["bf16"], "clip")
        out["record_amax"] = {**amax, "launches_per_window": amax[
            "launches_per_clip"] / info["windows"]}
    else:
        run, info = inference_run(torch, args.mode)
        out.update(info)
        out.update(profiled(torch, run, args.runs, 1, "clip", args.table,
                            card))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
