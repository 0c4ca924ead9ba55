#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``bin_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printed as one JSON line with its seconds as soon as it ends:

1. device   the card (nvidia-smi name and power limit), torch and CUDA
            versions, the TF32 switches as set;
2. build    the CUDA kernels, one nvcc call (or the cached build);
3. kernels  each kernel against its plain PyTorch version on the card at the
            main path's shapes (K2 exact at u8/bf16/fp32, also for a band
            wider than a stage and for views at unaligned addresses; K1
            within 1e-5), with its time, the plain version's, its bound and
            share of it and, for K2, the one PyTorch call that computes the
            same permutation;
4. card_vs_cpu  ``infer_clip`` of the released weights in fp32 with TF32 off,
            64x64, 6 keys: the card (kernels) against the port's CPU path
            (plain versions) within 1e-3;
5. slice    the main path: bf16 ``infer_clip`` of the released weights on a
            (1, 8, 720, 1280, 3) clip, a warm-up and timed runs, the kernel
            launches of one run, peak memory; then once more with the plain
            gate math and the plain pack, at least 40 dB apart.

Then the kernel table as one JSON line, and as the last line
``{"ok": true, "device": {...}}``.  Any failed check raises, so the script
exits non-zero and prints no result; so does a machine without CUDA.  It
writes nothing but the kernel build (``build/torch_kernels/``).
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time

WEIGHTS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "weights",
                       "prf_ema_r4.npz")
CLIP = (1, 8, 720, 1280, 3)          # what bench.py times
TIMED_RUNS = 3
HBM_BYTES_PER_S = 3.35e12            # H100 SXM data sheet
FP32_FLOPS_PER_S = 67e12             # H100 SXM, outside the tensor cores
# flops of one K1 output element: f + bias; three sigmoids at 3 each (exp,
# add, divide); two tanh at 1 each; three multiplies and one add
K1_FLOPS_PER_ELEMENT = 1 + 3 * 3 + 2 + 4
BUDGET_S = {"device": 30, "build": 60, "kernels": 60, "card_vs_cpu": 120,
            "slice": 240}


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


class Phase:
    """Times one phase and prints its JSON line when it ends."""

    def __init__(self, name: str):
        self.name = name
        self.info: dict = {}

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self.info

    def __exit__(self, exc_type, *_):
        if exc_type is None:
            sec = time.perf_counter() - self.t0
            emit({"phase": self.name, "seconds": round(sec, 3),
                  "budget_s": BUDGET_S[self.name], **self.info})
            require(sec <= BUDGET_S[self.name],
                    f"phase {self.name} took {sec:.1f} s, over its "
                    f"{BUDGET_S[self.name]} s budget")


def require(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def device_ms(torch, fn, reps: int = 20) -> float:
    """Median device time of ``fn`` in ms, by CUDA events, after a warm-up.
    A sleep kernel queued ahead of each run keeps the host's launch time out
    of the interval."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound_ms(nbytes: int, flops: int) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_kernels(torch, cfg) -> dict:
    from bin_tpu_torch.ops import lstm_gates, pixel_shuffle

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    f_lstm = cfg.convlstm_features
    down = cfg.stem_factor * 2 ** (len(cfg.channel_mult) - 1)
    hb, wb = CLIP[2] // down, CLIP[3] // down
    table = {}

    # K1 at the main path's shape, from bf16 gates (the model) and fp32
    cases, k1_err = [], 0.0
    for shape, feat, dt in [((1, hb, wb), f_lstm, torch.bfloat16),
                            ((1, hb, wb), f_lstm, torch.float32),
                            ((2, 5, 7), 48, torch.bfloat16),
                            ((3, 4), 300, torch.float32)]:
        gates = (torch.randn(*shape, 4 * feat, device=dev, generator=gen)
                 * 3).to(dt)
        c = torch.randn(*shape, feat, device=dev, generator=gen)
        h_k, c_k = lstm_gates.fused_lstm_gates(gates, c, 1.0)
        h_r, c_r = lstm_gates.lstm_gate_math_ref(gates, c, 1.0)
        err = max((h_k - h_r).abs().max().item(), (c_k - c_r).abs().max().item())
        require(err <= 1e-5, f"K1 {shape} {dt}: max abs diff {err} > 1e-5")
        cases.append({"shape": list(gates.shape), "gates": str(dt),
                      "max_abs_diff": err})
        k1_err = max(k1_err, err)
    gates = (torch.randn(1, hb, wb, 4 * f_lstm, device=dev, generator=gen)
             * 3).to(torch.bfloat16)
    c = torch.randn(1, hb, wb, f_lstm, device=dev, generator=gen)
    nbytes = gates.nbytes + c.nbytes + 2 * c.nbytes
    b_ms, b_by = bound_ms(nbytes, K1_FLOPS_PER_ELEMENT * c.numel())
    table["lstm_gates"] = {
        "name": "lstm_gates", "route": "cuda",
        "source": "bin_tpu_torch/csrc/lstm_gates.cu",
        "replaces": "bin_tpu/ops/pallas/lstm_gates.py:51",
        "max_abs_err": k1_err,
        "ms": device_ms(torch, lambda: lstm_gates.fused_lstm_gates(gates, c)),
        "plain_ms": device_ms(torch,
                              lambda: lstm_gates.lstm_gate_math_ref(gates, c)),
        "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes,
        "library_ms": None, "cases": cases}
    table["lstm_gates"]["share_of_bound"] = b_ms / table["lstm_gates"]["ms"]

    # K2: the clip pack at u8, bf16 and fp32, other factors and shapes, a
    # band wider than a stage, and views at addresses that are not 16-byte
    # aligned (the kernel's narrow-word path)
    def values(shape, dt, offset):
        """Random values of ``shape``, ``offset`` elements into a buffer."""
        size = math.prod(shape) + offset
        if dt == torch.uint8:
            flat = torch.randint(0, 256, (size,), device=dev, generator=gen,
                                 dtype=dt)
        else:
            flat = torch.rand(size, device=dev, generator=gen).to(dt)
        return flat[offset:].view(shape)

    cases, k2_err = [], 0.0
    for shape, f, dt, offset in [
            (CLIP, 2, torch.uint8, 0), (CLIP, 2, torch.bfloat16, 0),
            (CLIP, 2, torch.float32, 0),
            ((2, 3, 16, 24, 5), 4, torch.bfloat16, 0),
            ((6, 9, 2), 3, torch.float32, 0),
            ((1, 2, 64, 8192, 3), 2, torch.float32, 0),
            (CLIP, 2, torch.bfloat16, 1),
            ((1, 2, 72, 128, 3), 2, torch.uint8, 3),
            ((1, 2, 72, 128, 3), 2, torch.float32, 1)]:
        x = values(shape, dt, offset)
        out = pixel_shuffle.space_to_depth(x, f)
        ref = pixel_shuffle.space_to_depth_ref(x, f)
        require(out.shape == ref.shape and torch.equal(out, ref),
                f"K2 {shape} f={f} {dt} offset {offset}: not bit-exact")
        err = (out.float() - ref.float()).abs().max().item()
        c = shape[-1] * x.element_size()
        cases.append({
            "shape": list(shape), "factor": f, "dtype": str(dt),
            "address_mod_16": x.data_ptr() % 16,
            "plan": pixel_shuffle.pack_plan(shape[-2] * c, f * c, f,
                                            x.data_ptr(), out.data_ptr()),
            "max_abs_diff": err,
            "kernel_ms": device_ms(
                torch, lambda: pixel_shuffle.space_to_depth(x, f)),
            "bound_ms": bound_ms(2 * x.nbytes, 0)[0]})
        k2_err = max(k2_err, err)
    x = torch.rand(CLIP, device=dev, generator=gen).to(torch.bfloat16)
    n, k, h, w, ch = CLIP
    f = cfg.stem_factor
    b_ms, b_by = bound_ms(2 * x.nbytes, 0)
    k2_ms = device_ms(torch, lambda: pixel_shuffle.space_to_depth(x, f))
    table["s2d_pack"] = {
        "name": "s2d_pack", "route": "cuda",
        "source": "bin_tpu_torch/csrc/s2d_pack.cu",
        "replaces": "bin_tpu/ops/pallas/s2d_pack.py:69",
        "max_abs_err": k2_err, "ms": k2_ms,
        "plain_ms": device_ms(torch,
                              lambda: pixel_shuffle.space_to_depth_ref(x, f)),
        "bound_ms": b_ms, "bound_by": b_by, "bytes": 2 * x.nbytes,
        "share_of_bound": b_ms / k2_ms,
        "library_ms": device_ms(torch, lambda: x.view(
            n * k, h // f, f, w // f, f, ch).permute(0, 1, 3, 2, 4, 5)
            .contiguous()),
        "cases": cases}
    return table


def phase_card_vs_cpu(torch, params, cfg) -> dict:
    import dataclasses

    import numpy as np

    from bin_tpu_torch import build_model
    from bin_tpu_torch.ops import lstm_gates, pixel_shuffle

    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        cfg32 = dataclasses.replace(cfg, dtype="float32")
        x = torch.from_numpy(np.random.default_rng(0).uniform(
            0, 1, (1, 6, 64, 64, 3)).astype(np.float32))
        v_cpu, t_cpu = build_model(cfg32, "cpu").load_params(
            params).infer_clip(x)
        lstm_gates.launches = pixel_shuffle.launches = 0
        v_gpu, t_gpu = build_model(cfg32, "cuda").load_params(
            params).infer_clip(x.cuda())
        launches = {"lstm_gates": lstm_gates.launches,
                    "s2d_pack": pixel_shuffle.launches}
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = flags
    err = (v_gpu.cpu() - v_cpu).abs().max().item()
    require(list(t_cpu) == list(t_gpu), f"times {t_gpu} != CPU {t_cpu}")
    require(err <= 1e-3, f"card vs CPU: max abs diff {err} > 1e-3")
    require(launches == {"lstm_gates": 9, "s2d_pack": 1},
            f"card path launches {launches}")
    return {"shape": list(v_gpu.shape), "times": [int(t) for t in t_gpu],
            "max_abs_diff": err, "tolerance": 1e-3, "launches": launches}


def phase_slice(torch, params, cfg, card: str) -> dict:
    import dataclasses
    from unittest import mock

    import numpy as np

    from bin_tpu_torch import build_model
    from bin_tpu_torch.models import convlstm, recurrent
    from bin_tpu_torch.ops import lstm_gates, pixel_shuffle

    model = build_model(dataclasses.replace(cfg, dtype="bfloat16"),
                        "cuda").load_params(params)
    clip = torch.from_numpy(np.random.default_rng(0).uniform(
        0, 1, CLIP).astype(np.float32)).cuda()

    def run():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        video, times = model.infer_clip(clip)
        torch.cuda.synchronize()
        return video, times, (time.perf_counter() - t0) * 1e3

    _, _, warm_ms = run()
    torch.cuda.reset_peak_memory_stats()
    run_ms = []
    for _ in range(TIMED_RUNS):
        lstm_gates.launches = pixel_shuffle.launches = 0
        video, times, ms = run()
        launches = {"lstm_gates": lstm_gates.launches,
                    "s2d_pack": pixel_shuffle.launches}
        run_ms.append(ms)
    peak = torch.cuda.max_memory_allocated()
    n_out = 2 * (CLIP[1] - 1) - 1
    require(tuple(video.shape) == (1, n_out, *CLIP[2:]),
            f"video shape {tuple(video.shape)}")
    require(list(times) == list(range(1, n_out + 1)), f"times {times}")
    finite = bool(torch.isfinite(video).all())
    lo, hi = video.min().item(), video.max().item()
    require(finite and lo >= -0.5 and hi <= 1.5,
            f"video finite={finite} range [{lo}, {hi}]")
    require(launches == {"lstm_gates": 15, "s2d_pack": 1},
            f"main path launches {launches}")

    # the same clip with the plain gate math and the plain pack on the card
    lstm_gates.launches = pixel_shuffle.launches = 0
    with mock.patch.object(convlstm, "fused_lstm_gates",
                           lstm_gates.lstm_gate_math_ref), \
            mock.patch.object(recurrent, "space_to_depth",
                              pixel_shuffle.space_to_depth_ref):
        plain, _, plain_ms = run()
    require(lstm_gates.launches == 0 and pixel_shuffle.launches == 0,
            "the plain rerun launched a kernel")
    diff = (video - plain).double()
    mse = diff.square().mean().item()
    psnr = None if mse == 0 else 10 * np.log10(1.0 / mse)
    require(psnr is None or psnr >= 40, f"kernels vs plain: {psnr} dB < 40")
    ms = statistics.median(run_ms)
    return {"card": card, "dtype": "bfloat16", "clip": list(CLIP),
            "shape": list(video.shape), "times": [int(t) for t in times],
            "finite": finite, "min": lo, "max": hi,
            "warmup_ms": warm_ms, "run_ms": run_ms, "ms_per_clip": ms,
            "fps": n_out / (ms / 1e3), "launches": launches,
            "peak_memory_bytes": peak, "plain_ms": plain_ms,
            "vs_plain_max_abs_diff": diff.abs().max().item(),
            "vs_plain_psnr_db": psnr, "identical": mse == 0}


def main() -> int:
    t_start = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the smoke runs only on a card",
              file=sys.stderr)
        return 1

    with Phase("device") as info:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout.strip()
        print(smi, flush=True)
        card = smi.splitlines()[0]
        info.update(nvidia_smi=smi, torch=torch.__version__,
                    cuda=torch.version.cuda,
                    device=torch.cuda.get_device_name(0),
                    count=torch.cuda.device_count(),
                    cudnn_allow_tf32=torch.backends.cudnn.allow_tf32,
                    matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32)

    from bin_tpu_torch.ops import native
    from bin_tpu_torch.weights import load_weights

    with Phase("build") as info:
        built = native.build()
        native.library()
        info.update(nvcc_seconds=round(built["seconds"], 3),
                    cached=built["cached"], path=built["path"])

    params, cfg, _ = load_weights(WEIGHTS)
    with Phase("kernels") as info:
        table = phase_kernels(torch, cfg)
        info["kernels"] = [
            {"name": r["name"], "max_abs_diff": r["max_abs_err"],
             "kernel_ms": r["ms"], "plain_ms": r["plain_ms"],
             "bound_ms": r["bound_ms"], "library_ms": r["library_ms"],
             "share_of_bound": r["share_of_bound"],
             "cases": r.pop("cases")} for r in table.values()]

    with Phase("card_vs_cpu") as info:
        info.update(phase_card_vs_cpu(torch, params, cfg))

    with Phase("slice") as info:
        info.update(phase_slice(torch, params, cfg, card))
        for name, n in info["launches"].items():
            table[name]["launches"] = n

    emit({"kernels": list(table.values())})
    emit({"total_seconds": round(time.perf_counter() - t_start, 3),
          "card": card})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
