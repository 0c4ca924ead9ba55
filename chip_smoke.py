#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``bin_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printed as one JSON line with its seconds as soon as it ends:

1. device   the card (nvidia-smi name and power limit), torch and CUDA
            versions, the TF32 switches as set, whether PIL imports;
2. build    the CUDA kernels, one nvcc call (or the cached build);
3. kernels  each kernel against its plain PyTorch version on the card at the
            main path's shapes (K2 exact at u8/bf16/fp32, also for a band
            wider than a stage and for views at unaligned addresses; K1
            within 1e-5; K3q and K3 exact at every shape of the serving
            path and at ragged and odd ones, K3 also with the LeakyReLU and
            the residual add in its epilogue, each case checked more than
            once on freshly poisoned output memory), with its time, the plain
            version's, its bound and share of it and the PyTorch calls that
            compute the same function (K2: a permutation copy; K3: the
            im2col + ``torch._int_mm`` route, and cuDNN's bf16 conv of the
            shape for scale), and K3's and K3q's time per clip; K1b (the
            gate update's backward) at the train step's shape and the
            serving clip's; the int8 ops' refusal of inputs that require
            grad;
4. card_vs_cpu  ``infer_clip`` of the released weights in fp32 with TF32 off,
            64x64, 6 keys, float and with int8 on: the card (kernels)
            against the port's CPU path (plain versions);
5. slice    the bf16 main path: ``infer_clip`` of the released weights on a
            (1, 8, 720, 1280, 3) clip, a warm-up and timed runs, the kernel
            launches of each run, peak memory; then once more with every
            plain version, at least 40 dB apart;
6. serving  the same for the int8 serving mode that ``bench_torch.py``
            times, and its PSNR against the bf16 slice's video;
7. quality  the release card's pinned protocol (256x256, 16 clips of 12
            keys, seed 9999, textured) through
            ``bin_tpu_torch.evaluation.evaluate``, in bf16 and in the serving
            mode, each within 0.05 dB of its ``bin_tpu`` figure; and SSIM on
            the card against SSIM on the CPU on one clip's frames;
8. streaming  a 720p ``StreamingSession`` in the server's mode
            (``async_drain``, ``emit_u8``), in the serving mode and in bf16:
            60 u8 keys, free-running and then synchronized per key, each
            frame against ``infer_clip`` of the same keys bit for bit as it
            arrives, the launches of each key, the stream's ms per key over
            all keys, each key's latency, the pinned memory grown and peak
            memory;
9. http     ``bin-tpu-serve``'s ``make_http_server`` on 127.0.0.1 and a
            ``StreamClient``, serving mode: one 720p stream of 60 keys,
            after a warm-up stream, equal bit for bit to a direct session,
            the stream's ms per key over all keys;
10. train   training at config3_prf's full width (batch 4, 128x128 crops,
            6 keys, fp32, Adam, EMA 0.999): the loss and every gradient
            leaf of the card against the CPU on one fixed batch (batch 1,
            5 keys, TF32 off for the comparison), and the control, the card
            with TF32 on, refused by the same bounds; 10 steps through
            ``training.trainer.train`` warm-started from the release
            weights, each step's launches exact (9 K1, 6 K1b, 2 K2), every
            loss finite, no step skipped, ms per step by CUDA events, the
            host syncs inside a step, peak memory; the checkpoint resumed
            for one step against the uninterrupted step; the exported
            ``.npz`` through ``infer_clip``; and 30 steps on one fixed
            batch, whose loss must fall;
11. int8_release  the chain that makes an int8 release: (a) the release
            weights calibrated by ``python -m bin_tpu_torch.calibrate`` at
            ``tools/calibrate_int8.py``'s defaults, the same 63 keys as the
            committed sidecar (made on the TPU) and each scale near its
            own, and the pinned protocol served with the fresh sidecar
            within 0.05 dB of 28.5732; (b) one QAT clip (min_cin 256), the
            card against the CPU in fp32 with TF32 off under phase
            ``train``'s bounds, TF32 on refused, and ``fake_quant_conv`` at
            the serving path's widest shape against ``int8_conv``; (c)
            ``tools/qat_finetune.sh``'s fine-tune through ``train`` (QAT,
            bf16, remat, EMA 0.999, lr 1e-5) for 10 steps from the release,
            the eval every 10 steps keeping ``best.npz``, the watchdog
            armed: launches exact, every loss finite, no step skipped, no
            host sync inside a step after the first; (d) 30 bf16 steps on
            phase ``train``'s fixed batch beside its fp32 ones, and the
            bf16 gradient against the fp32 one; (e) ``best.npz``
            calibrated on 2 clips and served as the server and the
            evaluator serve it: its card's config (QAT flag and all) in
            the serving mode with the new sidecar named, which the
            entries' provenance check accepts (and refuses the release's),
            at 720p through K3q and K3 and no QAT conv;
12. folder  a user's footage through ``python -m bin_tpu_torch.cli`` at
            config4_gopro_720p's full width: (a) a sharp 240 fps .npy tree
            at 720x1280 (3 clips of 67 frames) through ``cli prep`` (8
            blurry keys and 15 sharp frames a clip, a key equal to the
            mean of its 11 taps); (b) ``cli train`` from the release
            weights on it, 10 steps with 4 loader workers, a checkpoint and
            an in-training eval every 5 steps: each step's launches exact
            (9 K1, 6 K1b, 2 K2), every loss finite, none skipped, the
            loader's state at step 5; a copy of the workdir resumed from
            step 5, whose batches (by digest) equal the uninterrupted
            run's, its first step's loss bit for bit and the later ones
            within 1e-3 (cuDNN deterministic for both); (c) ms per
            step through ``train`` on config3_prf's synthetic stream, the
            thread loader against 4 workers (steps 5-10, CUDA events) and
            the device's idle share, recorded, not gated; (d) ``cli
            export --ema`` and ``cli eval`` of the whole clips at 720x1280
            from the checkpoint and from the .npz, equal, 15 K1 and 1 K2 a
            clip, a clip's frames finite; (e) ``log.debug_nans`` raising on
            a NaN batch before the update; (f) ``cli demo`` on a clip's
            blurry folder (where PIL is installed; the phase line says so
            otherwise);
13. perceptual  the VGG-16 term: its loss and gradient card against CPU
            (fp32, TF32 off), a ``.pth`` of the fallback filters through
            ``loss.vgg_weights`` giving the fallback's loss, and ``cli
            train --preset config3_prf_extended --set
            loss.perceptual_mode=vgg`` from the release weights, 20 steps
            with 4 loader workers: launches exact, ms per step from start
            to start, the device's idle share, peak memory;
14. import_torch  the release weights as a ``module.``-prefixed PyTorch
            checkpoint in a temporary directory outside the repo, back
            through ``cli import-torch``: the arrays and the card equal,
            ``infer_clip`` at 720p bit for bit, the files removed;
15. parallel  config5_v5e_streaming (stem 4, base 256, bf16) at full
            width on phase folder's tree: ``cli train`` for 10 steps in
            this process and under ``torchrun`` (NCCL, one rank; this
            script's ``--rank-cli`` mode), the losses within 1e-3, the
            whole-clip 720p evals of the checkpoint equal to the last bit,
            launches exact; then ``bench_torch.py --stem 4 --base 256`` in
            bf16 and serving, and ``--streaming --batch 8`` at both stems.
            Phase ``kernels`` holds every K3q and K3 call of one window of
            config5's serving model (``config5_serving_model``).

Then the kernel table as one JSON line, and as the last line
``{"ok": true, "device": {...}}``.  Any failed check raises, so the script
exits non-zero and prints no result; so does a machine without CUDA.  It
writes nothing but the kernel build (``build/torch_kernels/``) and the
run directories of phases ``train``, ``int8_release``, ``folder`` and
``parallel`` (under ``build/``, removed at their ends) and the temporary
files of ``perceptual`` and ``import_torch`` (under the system's
temporary directory, removed).
"""

from __future__ import annotations

import contextlib
import faulthandler
import inspect
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
INT8_OPS_PER_S = 1979e12             # H100 SXM, dense int8 tensor cores
# flops of one K1 output element: f + bias; three sigmoids at 3 each (exp,
# add, divide); two tanh at 1 each; three multiplies and one add
K1_FLOPS_PER_ELEMENT = 1 + 3 * 3 + 2 + 4
# K1b: the same 12 for the recomputed nonlinearities and c', 5 for dc', 4
# for each of the four gate cotangents, 1 for dc
K1B_FLOPS_PER_ELEMENT = 12 + 3 + 5 + 4 * 4 + 1
BUDGET_S = {"device": 30, "build": 60, "kernels": 120, "card_vs_cpu": 120,
            "slice": 240, "serving": 240, "quality": 150, "streaming": 90,
            "http": 60, "train": 420, "int8_release": 240, "folder": 240,
            "perceptual": 120, "import_torch": 60, "parallel": 300}
# the pinned protocol's psnr_overall measured with bin_tpu: bf16 from the
# release card (weights/prf_ema_r4.card.json), the serving mode from
# BASELINE.md's static-scales table; 0.05 dB is the repo's quality budget
# (BASELINE.json)
QUALITY_PSNR = {"bf16": 28.5775, "serving": 28.5732}
QUALITY_BUDGET_DB = 0.05
CARD_SSIM = 0.8019                   # reported beside the port's, not gated
SSIM_CARD_VS_CPU_ATOL = 1e-5
# keys of a timed stream: at ~25-30 ms a key on an H100, ~2 s a stream
STREAM_KEYS = HTTP_KEYS = 60


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


class Phase:
    """Times one phase and prints its JSON line when it ends."""

    def __init__(self, name: str):
        self.name = name
        self.info: dict = {}

    def __enter__(self):
        self.t0 = time.perf_counter()
        # a phase that hangs prints every thread's stack and ends the run
        faulthandler.dump_traceback_later(BUDGET_S[self.name] + 120,
                                          exit=True)
        return self.info

    def __exit__(self, exc_type, *_):
        faulthandler.cancel_dump_traceback_later()
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


def bound_ms(nbytes: int, flops: int,
             ops_per_s: float = FP32_FLOPS_PER_S) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def config5_shapes() -> dict:
    """config5_v5e_streaming's shapes on its paths: the ConvLSTM gates of a
    720p clip and of a train step (batch 8, 128x128 crops; bf16 gates, the
    preset's dtype), and its stem factor."""
    from bin_tpu_torch.config import get_config

    c5 = get_config("config5_v5e_streaming")
    m = c5.model
    down = m.stem_factor * 2 ** (len(m.channel_mult) - 1)
    return {"stem": m.stem_factor, "features": m.convlstm_features,
            "clip_gates": (1, CLIP[2] // down, CLIP[3] // down),
            "train_gates": (c5.data.batch_size, c5.data.crop_size[0] // down,
                            c5.data.crop_size[1] // down)}


def lstm_library(torch, gates, c):
    """PyTorch's fused LSTM cell, ``aten._thnn_fused_lstm_cell``: one CUDA
    call for K1's function, gates in the same (i, f, g, o) order.  Its
    inputs are K1's: ``input_gates`` the gates as (N, 4F) fp32 (cast where
    they are bf16: the call takes one dtype, and the cast is in its time),
    ``hidden_gates`` zeros, the forget bias of 1 in ``hidden_bias``.
    Returns (the call, its (h, c, workspace)) or (None, why) where this
    PyTorch lacks it."""
    op = getattr(torch.ops.aten, "_thnn_fused_lstm_cell", None)
    if op is None:
        return None, "torch.ops.aten._thnn_fused_lstm_cell is missing"
    f = c.shape[-1]
    g2 = gates.reshape(-1, 4 * f)
    zeros = torch.zeros(g2.shape, device=c.device)
    in_bias = torch.zeros(4 * f, device=c.device)
    hid_bias = in_bias.clone()
    hid_bias[f:2 * f] = 1.0
    c2 = c.reshape(-1, f)

    def call():
        return op(g2.float(), zeros, c2, in_bias, hid_bias)

    return call, call()


def phase_kernels(torch, cfg) -> dict:
    from bin_tpu_torch.ops import lstm_gates, pixel_shuffle

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    f_lstm = cfg.convlstm_features
    down = cfg.stem_factor * 2 ** (len(cfg.channel_mult) - 1)
    hb, wb = CLIP[2] // down, CLIP[3] // down
    c5 = config5_shapes()
    eval_clip = eval_clip_shape(cfg)
    ehb, ewb = eval_clip[2] // down, eval_clip[3] // down
    table = {}

    # K1 at the main path's shape (the 720p clip's and key's) and at the
    # eval clip's, from bf16 gates (the model) and fp32
    tb, th = TRAIN_BATCH, TRAIN_CROP // down
    cases, k1_err = [], 0.0
    for path, shape, feat, dt in [
            ("720p", (1, hb, wb), f_lstm, torch.bfloat16),
            ("720p", (1, hb, wb), f_lstm, torch.float32),
            ("eval", (1, ehb, ewb), f_lstm, torch.bfloat16),
            ("eval", (1, ehb, ewb), f_lstm, torch.float32),
            ("train", (tb, th, th), f_lstm, torch.bfloat16),
            ("train", (tb, th, th), f_lstm, torch.float32),
            ("config5 720p", c5["clip_gates"], c5["features"],
             torch.bfloat16),
            ("config5 train", c5["train_gates"], c5["features"],
             torch.bfloat16),
            (None, (2, 5, 7), 48, torch.bfloat16),
            (None, (3, 4), 300, torch.float32)]:
        gates = (torch.randn(*shape, 4 * feat, device=dev, generator=gen)
                 * 3).to(dt)
        c = torch.randn(*shape, feat, device=dev, generator=gen)
        h_k, c_k = lstm_gates.fused_lstm_gates(gates, c, 1.0)
        h_r, c_r = lstm_gates.lstm_gate_math_ref(gates, c, 1.0)
        err = max((h_k - h_r).abs().max().item(), (c_k - c_r).abs().max().item())
        require(err <= 1e-5, f"K1 {shape} {dt}: max abs diff {err} > 1e-5")
        cases.append({"path": path, "shape": list(gates.shape),
                      "gates": str(dt), "max_abs_diff": err})
        k1_err = max(k1_err, err)
    def k1_timing(shape, feat, dt):
        """K1 at one shape against its bound, its plain version and the
        library's fused cell (checked against K1 within K1's 1e-5)."""
        gates = (torch.randn(*shape, 4 * feat, device=dev, generator=gen)
                 * 3).to(dt)
        c = torch.randn(*shape, feat, device=dev, generator=gen)
        nbytes = gates.nbytes + c.nbytes + 2 * c.nbytes
        b_ms, b_by = bound_ms(nbytes, K1_FLOPS_PER_ELEMENT * c.numel())
        k_ms = device_ms(torch,
                         lambda: lstm_gates.fused_lstm_gates(gates, c))
        row = {"shape": list(gates.shape), "gates": str(dt), "ms": k_ms,
               "plain_ms": device_ms(
                   torch, lambda: lstm_gates.lstm_gate_math_ref(gates, c)),
               "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes,
               "share_of_bound": b_ms / k_ms}
        call, out = lstm_library(torch, gates, c)
        if call is None:
            return {**row, "library_ms": None, "library": out}
        h_k, c_k = lstm_gates.fused_lstm_gates(gates, c)
        err = max((out[0].view(c.shape) - h_k).abs().max().item(),
                  (out[1].view(c.shape) - c_k).abs().max().item())
        require(err <= 1e-5, f"the library's LSTM cell at {row['shape']} "
                f"differs from K1 by {err}: not the same function")
        return {**row, "library_ms": device_ms(torch, call),
                "library": "aten._thnn_fused_lstm_cell"
                           + (" after a cast of the gates to fp32"
                              if dt != torch.float32 else ""),
                "library_vs_k1_max_abs_diff": err}

    serving = k1_timing((1, hb, wb), f_lstm, torch.bfloat16)
    table["lstm_gates"] = {
        "name": "lstm_gates", "route": "cuda",
        "source": "bin_tpu_torch/csrc/lstm_gates.cu",
        "replaces": "bin_tpu/ops/pallas/lstm_gates.py:51",
        "max_abs_err": k1_err, **serving, "cases": cases,
        # the fp32 train step's shape, the bf16 train step's (bf16
        # training, QAT: the 16x16 bottleneck of a 128x128 crop, batch 4)
        # and config5_v5e_streaming's clip and train step (bf16 gates)
        "train_shape_fp32": k1_timing((tb, th, th), f_lstm, torch.float32),
        "train_shape_bf16": k1_timing((tb, th, th), f_lstm, torch.bfloat16),
        "config5_clip_shape": k1_timing(c5["clip_gates"], c5["features"],
                                        torch.bfloat16),
        "config5_train_shape": k1_timing(c5["train_gates"], c5["features"],
                                         torch.bfloat16)}
    table["lstm_gates_bwd"] = phase_k1b(torch, cfg, gen)

    # K2: the clip pack at u8, bf16 and fp32, the eval clip's (bf16), other
    # factors and shapes, a
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
            (CLIP, 2, torch.float32, 0), (eval_clip, 2, torch.bfloat16, 0),
            (CLIP, 4, torch.uint8, 0), (CLIP, 4, torch.bfloat16, 0),
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

    # config5_v5e_streaming's pack: the 720p clip at f = 4, u8 (a clip of
    # video) and bf16 (the model's)
    f4 = c5["stem"]
    for dt in (torch.uint8, torch.bfloat16):
        x4 = values(CLIP, dt, 0)
        b_ms, b_by = bound_ms(2 * x4.nbytes, 0)
        k_ms = device_ms(torch, lambda: pixel_shuffle.space_to_depth(x4, f4))
        table["s2d_pack"].setdefault("config5_f4", {})[str(dt)] = {
            "shape": list(CLIP), "factor": f4, "bit_exact": True,
            "ms": k_ms, "plain_ms": device_ms(
                torch, lambda: pixel_shuffle.space_to_depth_ref(x4, f4)),
            "bound_ms": b_ms, "bound_by": b_by, "bytes": 2 * x4.nbytes,
            "share_of_bound": b_ms / k_ms,
            "library_ms": device_ms(torch, lambda: x4.view(
                n * k, h // f4, f4, w // f4, f4, ch)
                .permute(0, 1, 3, 2, 4, 5).contiguous())}

    # the streaming ingest: one u8 key per push, packed before the /255
    key = values((1, h, w, ch), torch.uint8, 0)
    require(torch.equal(pixel_shuffle.space_to_depth(key, f),
                        pixel_shuffle.space_to_depth_ref(key, f)),
            "K2 u8 per key: not bit-exact")
    b_ms, b_by = bound_ms(2 * key.nbytes, 0)
    key_ms = device_ms(torch, lambda: pixel_shuffle.space_to_depth(key, f))
    table["s2d_pack"]["per_key_u8"] = {
        "shape": list(key.shape), "factor": f, "dtype": str(key.dtype),
        "bit_exact": True, "ms": key_ms,
        "plain_ms": device_ms(
            torch, lambda: pixel_shuffle.space_to_depth_ref(key, f)),
        "bound_ms": b_ms, "bound_by": b_by, "bytes": 2 * key.nbytes,
        "share_of_bound": b_ms / key_ms,
        "library_ms": device_ms(torch, lambda: key.view(
            h // f, f, w // f, f, ch).permute(0, 2, 1, 3, 4).contiguous())}
    return table


# K1b against its plain version: within 1e-5 where dgates is fp32; with
# bf16 gates dgates is rounded once to bf16, and an fp32 value one ulp
# apart (the kernel's fused multiply-adds against PyTorch's order) may round
# to the neighbouring bf16 value, so there each value is held within one
# bf16 rounding (2^-8 relative) of the plain fp32 VJP, plus 1e-5.
K1B_ATOL = 1e-5


def phase_k1b(torch, cfg, gen) -> dict:
    """K1b at the train step's shape (fp32 gates of the ConvLSTM at the
    16x16 bottleneck of a 128x128 crop, batch 4; and bf16 gates, as bf16
    training and QAT give it), at the serving clip's ((1, 90, 160, 1024)
    bf16 gates) and at ragged ones; its row of the kernel table (timed at
    the fp32 train step's shape, the path that runs it), with the bf16
    train shape's and the serving shape's times beside it.  The int8 ops refuse CUDA
    inputs that require grad."""
    from bin_tpu_torch.ops import lstm_gates, quant

    dev = torch.device("cuda")
    f_lstm = cfg.convlstm_features
    down = cfg.stem_factor * 2 ** (len(cfg.channel_mult) - 1)
    tb, th = TRAIN_BATCH, TRAIN_CROP // down
    hb, wb = CLIP[2] // down, CLIP[3] // down

    def inputs(shape, feat, dt):
        gates = (torch.randn(*shape, 4 * feat, device=dev, generator=gen)
                 * 3).to(dt)
        c, dh, dc = (torch.randn(*shape, feat, device=dev, generator=gen)
                     for _ in range(3))
        return gates, c, dh, dc

    c5 = config5_shapes()
    cases, err_all, timed = [], 0.0, {}
    for path, shape, feat, dt in [
            ("train", (tb, th, th), f_lstm, torch.float32),
            ("train_bf16", (tb, th, th), f_lstm, torch.bfloat16),
            ("720p", (1, hb, wb), f_lstm, torch.bfloat16),
            ("config5_train", c5["train_gates"], c5["features"],
             torch.bfloat16),
            (None, (2, 5, 7), 48, torch.bfloat16),
            (None, (3, 4), 300, torch.float32)]:
        args = inputs(shape, feat, dt)
        dg_k, dc_k = lstm_gates.fused_lstm_gates_bwd(*args)
        dg_r, dc_r = lstm_gates.lstm_gates_bwd_ref(args[0].float(),
                                                   *args[1:])
        require(dg_k.dtype == dt and dc_k.dtype == torch.float32,
                f"K1b {shape}: dtypes {dg_k.dtype}, {dc_k.dtype}")
        dg_err = (dg_k.float() - dg_r).abs()
        bound = K1B_ATOL + (dg_r.abs() * 2.0 ** -8 if dt == torch.bfloat16
                            else 0.0)
        err = max(dg_err.max().item(), (dc_k - dc_r).abs().max().item())
        require(bool((dg_err <= bound).all())
                and (dc_k - dc_r).abs().max().item() <= K1B_ATOL,
                f"K1b {shape} {dt}: max abs diff {err}")
        flips = (0 if dt == torch.float32 else
                 int((dg_k != dg_r.to(dt)).sum().item()))
        cases.append({"path": path, "shape": list(args[0].shape),
                      "gates": str(dt), "max_abs_diff": err,
                      "bf16_values_off_the_plain_rounding": flips})
        err_all = max(err_all, err)
        if path:
            # gates read and dgates written; c, dh, dc_out read, dc written
            nbytes = 2 * args[0].nbytes + 4 * args[1].nbytes
            b_ms, b_by = bound_ms(nbytes,
                                  K1B_FLOPS_PER_ELEMENT * args[1].numel())
            k_ms = device_ms(torch,
                             lambda: lstm_gates.fused_lstm_gates_bwd(*args))
            timed[path] = {
                "shape": list(args[0].shape), "gates": str(dt), "ms": k_ms,
                "plain_ms": device_ms(torch, lambda: lstm_gates
                                      .lstm_gates_bwd_ref(*args)),
                "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes,
                "share_of_bound": b_ms / k_ms}

    # the int8 ops have no backward: a grad-requiring input raises
    x = torch.rand(1, 8, 8, 32, device=dev, requires_grad=True)
    qw, ks = quant.quantize_weight(torch.randn(32, 32, 3, 3, device=dev))
    refused = 0
    for fn in (lambda: quant.quantize_act(x, torch.tensor(0.01,
                                                          device=dev)),
               lambda: quant.int8_conv(x, qw, ks, None, 1, (1, 1), 0.01)):
        try:
            fn()
        except RuntimeError as e:
            refused += "no backward" in str(e)
    require(refused == 2, "an int8 op took an input that requires grad")
    row = timed["train"]
    row.update(lstm_bwd_library(torch, cfg, gen, (tb, th, th), f_lstm))
    return {"name": "lstm_gates_bwd", "route": "cuda",
            "source": "bin_tpu_torch/csrc/lstm_gates.cu",
            "replaces": "bin_tpu/ops/pallas/lstm_gates.py:81",
            "max_abs_err": err_all, "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "bytes": row["bytes"],
            "share_of_bound": row["share_of_bound"],
            "library_ms": row["library_ms"], "library": row["library"],
            "train_shape_bf16": timed["train_bf16"],
            "serving_shape": timed["720p"],
            "config5_train_shape": timed["config5_train"],
            "int8_refuses_grad": True, "cases": cases}


def lstm_bwd_library(torch, cfg, gen, shape, feat) -> dict:
    """PyTorch's backward of its fused LSTM cell,
    ``aten._thnn_fused_lstm_cell_backward_impl``, on K1b's fp32 inputs at
    ``shape``: it reads the workspace (the activated gates) that its
    forward saved, where K1b recomputes them from the gates.  Checked
    against K1b within K1b's 1e-5; (library_ms, what) or None and why."""
    from bin_tpu_torch.ops import lstm_gates

    dev = torch.device("cuda")
    op = getattr(torch.ops.aten, "_thnn_fused_lstm_cell_backward_impl", None)
    gates = torch.randn(*shape, 4 * feat, device=dev, generator=gen) * 3
    c, dh, dc = (torch.randn(*shape, feat, device=dev, generator=gen)
                 for _ in range(3))
    call, out = lstm_library(torch, gates, c)
    if op is None or call is None:
        return {"library_ms": None, "library": "missing in this PyTorch"}
    _, cy, ws = out

    def bwd():
        return op(dh.reshape(-1, feat), dc.reshape(-1, feat),
                  c.reshape(-1, feat), cy, ws, True)

    dg_l, dc_l, _ = bwd()
    dg_k, dc_k = lstm_gates.fused_lstm_gates_bwd(gates, c, dh, dc)
    err = max((dg_l.view(dg_k.shape) - dg_k).abs().max().item(),
              (dc_l.view(dc_k.shape) - dc_k).abs().max().item())
    require(err <= K1B_ATOL, f"the library's LSTM cell backward differs "
            f"from K1b by {err}: not the same function")
    return {"library_ms": device_ms(torch, bwd),
            "library": "aten._thnn_fused_lstm_cell_backward_impl (reads "
                       "the forward's workspace)",
            "library_vs_k1b_max_abs_diff": err}


def eval_clip_shape(cfg) -> tuple:
    """The clip that phase quality feeds the model: (1, keys, H, W, 3) of
    the release card's pinned protocol."""
    from bin_tpu_torch.config import Config, DataConfig
    from bin_tpu_torch.evaluation.evaluator import protocol_source

    protocol, _ = protocol_source(Config(model=cfg, data=DataConfig()))
    return (1, protocol["keys"], *protocol["size"], 3)


def int8_path_cases(torch, cfg, clip, path: str) -> list:
    """K3's shapes on the serving path of ``clip`` (1, K, H, W, 3), whose
    windows the model runs one at a time (so a streamed key of the same
    frame size gives the same shapes), each with its launches per clip."""
    bf16, fp32 = torch.bfloat16, torch.float32
    f = cfg.stem_factor
    c1, c2 = (cfg.base_features * m for m in cfg.channel_mult[1:3])
    h1, w1 = clip[2] // (2 * f), clip[3] // (2 * f)  # enc_1, dec_1, down_1
    h2, w2 = h1 // 2, w1 // 2                          # mid, the ConvLSTM
    windows = clip[1] - cfg.window_size + 1
    levels = cfg.num_levels + int(cfg.cycle_level)
    gates = 4 * cfg.convlstm_features
    tag = "" if path == "720p" else f"{path} "
    cases = []
    for level in range(levels):
        b = cfg.window_size - 1 - level  # frame pairs at this level
        cases += [
            (f"{tag}enc_1/dec_1 b{b}", (b, h1, w1, c1), c1, 1, bf16, bf16,
             True, False, 4 * windows, path),
            (f"{tag}down_1 b{b}", (b, h1, w1, c1), c2, 2, bf16, bf16, True,
             False, windows, path),
            (f"{tag}mid b{b}", (b, h2, w2, c2), c2, 1, bf16, bf16, True, False,
             2 * cfg.num_res_blocks * windows, path)]
    return cases + [
        (f"{tag}lstm gates_x", (1, h2, w2, c2), gates, 1, bf16, fp32, True,
         False, levels * windows, path),
        (f"{tag}lstm gates_h", (1, h2, w2, cfg.convlstm_features), gates, 1,
         bf16, bf16, False, True, levels * windows, path)]


def int8_cases(torch, cfg) -> list:
    """K3's shapes: (name, (N, H, W, Cin), Cout, stride, in/out dtypes,
    bias, addend, launches per clip of the path, path).  Those of the 720p
    clip (path "720p", timed), of the eval clip at the pinned protocol's
    256x256 (path "eval"), then ragged and odd shapes off the path (M, Cout
    and K not multiples of the tile, odd sizes at stride 2; path None)."""
    bf16, fp32 = torch.bfloat16, torch.float32
    return [
        *int8_path_cases(torch, cfg, CLIP, "720p"),
        *int8_path_cases(torch, cfg, eval_clip_shape(cfg), "eval"),
        ("ragged s1", (2, 7, 9, 32), 72, 1, fp32, fp32, True, False, 0, None),
        ("odd s2", (1, 9, 11, 96), 8, 2, bf16, bf16, False, True, 0, None),
        ("ragged s2", (2, 5, 6, 64), 136, 2, fp32, fp32, True, True, 0,
         None)]


def epilogue_cases(torch, cfg) -> list:
    """K3 with the pass that follows it in the backbone: (case of
    ``int8_cases`` by name, slope, residual).  The LeakyReLU on enc_1's
    Conv_0 and on down_1, the residual add on a mid ResBlock's Conv_1, at
    the 720p clip's and the eval clip's shapes; both on the ragged and odd
    shapes."""
    slope, b = cfg.lrelu_slope, cfg.window_size - 1
    return [*((f"{tag}{name} b{b}", s, r) for tag in ("", "eval ")
              for name, s, r in (("enc_1/dec_1", slope, False),
                                 ("down_1", slope, False),
                                 ("mid", None, True))),
            ("ragged s1", slope, True), ("odd s2", slope, False),
            ("odd s2", None, True), ("ragged s2", slope, True)]


def phase_int8_kernels(torch, cfg) -> tuple[dict, dict]:
    """K3q and K3 at every shape of the serving path, the 720p clip's and
    the eval clip's, and at ragged and odd ones, and K3 with its epilogue's
    LeakyReLU and residual add, each bit for bit against its plain version
    (``torch.equal``) more than once, the output's memory poisoned with NaN
    before each run; timed on the 720p path's shapes beside the plain
    version, the bound, the im2col + ``torch._int_mm`` route and cuDNN's
    bf16 conv of the shape."""
    import torch.nn.functional as F

    from bin_tpu_torch.models.layers import _same_pad
    from bin_tpu_torch.ops import quant

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    scale = torch.tensor(0.015, device=dev)  # |x| > 1.9 saturates
    cases = {c[0]: c for c in int8_cases(torch, cfg)}
    widest = next(iter(cases))

    def inputs(case):
        (name, shape, cout, stride, in_dt, out_dt, has_bias, has_addend,
         *_) = case
        n, h, w, cin = shape
        ho, wo = -(-h // stride), -(-w // stride)
        pad = (_same_pad(h, 3, stride)[0], _same_pad(w, 3, stride)[0])
        x = (torch.randn(shape, device=dev, generator=gen) * 0.5).to(in_dt)
        weight = torch.randn(cout, cin, 3, 3, device=dev, generator=gen) * 0.05
        qw, ks = quant.quantize_weight(weight)
        bias = (torch.randn(cout, device=dev, generator=gen)
                if has_bias else None)
        addend = (torch.randn(n, ho, wo, cout, device=dev, generator=gen)
                  if has_addend else None)
        residual = torch.randn(n, ho, wo, cout, device=dev,
                               generator=gen).to(out_dt)
        return x, weight, qw, ks, bias, addend, residual, pad

    def check_k3(name, args, kw):
        """K3 against its plain version, twice (five times at the widest
        shape), each on output memory just filled with NaN and freed."""
        ref = quant.int8_conv3x3_ref(*args, **kw)
        for _ in range(5 if name == widest else 2):
            torch.full_like(ref, float("nan"))  # freed: the next output's
            out = quant.int8_conv3x3(*args, **kw)
            torch.cuda.synchronize()
            require(out.shape == ref.shape and torch.equal(out, ref),
                    f"K3 {name} {kw and sorted(kw)}: not bit-exact")
        return (out.float() - ref.float()).abs().max().item()

    def timing(case, x, weight, xq, args, kw, nbytes):
        """The kernel against its bound, its plain version and the library
        routes, at one shape."""
        name, shape, cout, stride = case[:4]
        n, h, w, cin = shape
        ops = 2 * n * -(-h // stride) * -(-w // stride) * cout * 9 * cin
        b_ms, b_by = bound_ms(nbytes, ops, INT8_OPS_PER_S)
        xc = x.to(torch.bfloat16).permute(0, 3, 1, 2)
        wc = weight.to(torch.bfloat16).contiguous(
            memory_format=torch.channels_last)
        bias = args[4]
        bc = None if bias is None else bias.to(torch.bfloat16)
        t = {"ops": ops, "bytes": nbytes, "bound_ms": b_ms, "bound_by": b_by,
             "ms": device_ms(torch, lambda: quant.int8_conv3x3(*args, **kw)),
             "plain_ms": device_ms(
                 torch, lambda: quant.int8_conv3x3_ref(*args, **kw)),
             "im2col_int_mm_ms": device_ms(torch, lambda: quant.int8_conv_ref(
                 xq, args[1], stride, args[6])),
             "cudnn_bf16_ms": device_ms(torch, lambda: F.conv2d(
                 xc, wc, bc, stride, 1))}
        t["share_of_bound"] = b_ms / t["ms"]
        t["tops"] = ops / t["ms"] / 1e9
        return t

    k3_cases, k3q_cases = [], []
    per_clip = {"launches": 0, "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                "im2col_int_mm_ms": 0.0, "cudnn_bf16_ms": 0.0,
                "quantize_ms": 0.0, "quantize_plain_ms": 0.0,
                "quantize_bound_ms": 0.0}
    made = {}
    for case in cases.values():
        (name, shape, cout, stride, in_dt, out_dt, has_bias, has_addend,
         per, path) = case
        timed = path == "720p"
        x, weight, qw, ks, bias, addend, residual, pad = made[name] = (
            inputs(case))
        xq = quant.quantize_act(x, scale)
        require(torch.equal(xq, quant.quantize_act_ref(x, scale)),
                f"K3q {name} {shape} {in_dt}: not bit-exact")
        args = (xq, qw, ks, scale, bias, stride, pad, out_dt, addend)
        k3 = {"case": name, "path": path, "x": list(shape), "cout": cout,
              "stride": stride, "pad": list(pad), "out": str(out_dt),
              "bias": has_bias, "addend": has_addend,
              "launches_per_clip": per,
              "max_abs_diff": check_k3(name, args, {}), "bit_exact": True}
        k3q = {"case": name, "path": path, "x": list(shape),
               "dtype": str(in_dt), "launches_per_clip": per,
               "max_abs_diff": 0.0, "bit_exact": True}
        if timed:
            nbytes = (xq.nbytes + qw.nbytes + ks.nbytes + 4
                      + n_out_bytes(out_dt, shape, cout, stride)
                      + (bias.nbytes if has_bias else 0)
                      + (addend.nbytes if has_addend else 0))
            k3.update(timing(case, x, weight, xq, args, {}, nbytes))
            q_bytes = x.nbytes + xq.nbytes
            k3q.update(
                bytes=q_bytes, bound_ms=bound_ms(q_bytes, 0)[0],
                ms=device_ms(torch, lambda: quant.quantize_act(x, scale)),
                plain_ms=device_ms(torch,
                                   lambda: quant.quantize_act_ref(x, scale)))
            k3q["share_of_bound"] = k3q["bound_ms"] / k3q["ms"]
            per_clip["launches"] += per
            for key in ("ms", "plain_ms", "bound_ms", "im2col_int_mm_ms",
                        "cudnn_bf16_ms"):
                per_clip[key] += per * k3[key]
            for key in ("ms", "plain_ms", "bound_ms"):
                per_clip["quantize_" + key] += per * k3q[key]
        k3_cases.append(k3)
        k3q_cases.append(k3q)
    per_clip["share_of_bound"] = per_clip["bound_ms"] / per_clip["ms"]

    # the epilogue: the LeakyReLU and the residual add of the backbone
    for name, slope, with_residual in epilogue_cases(torch, cfg):
        case = cases[name]
        (_, shape, cout, stride, _, out_dt, has_bias, has_addend, _,
         path) = case
        x, weight, qw, ks, bias, addend, residual, pad = made[name]
        xq = quant.quantize_act(x, scale)
        args = (xq, qw, ks, scale, bias, stride, pad, out_dt, addend)
        kw = {"slope": slope, "residual": residual if with_residual else None}
        k3 = {"case": name, "path": path, "x": list(shape), "cout": cout,
              "stride": stride, "out": str(out_dt), "bias": has_bias,
              "addend": has_addend, "slope": slope,
              "residual": with_residual, "launches_per_clip": 0,
              "max_abs_diff": check_k3(name, args, kw), "bit_exact": True}
        if path == "720p":
            nbytes = (xq.nbytes + qw.nbytes + ks.nbytes + 4
                      + n_out_bytes(out_dt, shape, cout, stride)
                      * (2 if with_residual else 1)
                      + (bias.nbytes if has_bias else 0)
                      + (addend.nbytes if has_addend else 0))
            k3.update(timing(case, x, weight, xq, args, kw, nbytes))
        k3_cases.append(k3)

    # the rows: the widest shape of the path, (3, 180, 320, 256) -> 256
    k3, k3q = k3_cases[0], k3q_cases[0]
    rows = {
        "quantize_act": {
            "name": "quantize_act", "route": "cuda",
            "source": "bin_tpu_torch/csrc/int8_conv.cu",
            "replaces": "bin_tpu/ops/quant.py:203 (an XLA op, no Pallas "
                        "kernel)",
            "max_abs_err": 0.0, "ms": k3q["ms"], "plain_ms": k3q["plain_ms"],
            "bound_ms": k3q["bound_ms"], "bound_by": "bytes",
            "bytes": k3q["bytes"], "share_of_bound": k3q["share_of_bound"],
            "library_ms": None, "shape": k3q["x"], "cases": k3q_cases},
        "int8_conv": {
            "name": "int8_conv", "route": "cuda",
            "source": "bin_tpu_torch/csrc/int8_conv.cu",
            "replaces": "bin_tpu/ops/quant.py:205 (an XLA conv, no Pallas "
                        "kernel)",
            "max_abs_err": max(c["max_abs_diff"] for c in k3_cases),
            "ms": k3["ms"], "plain_ms": k3["plain_ms"],
            "bound_ms": k3["bound_ms"], "bound_by": k3["bound_by"],
            "bytes": k3["bytes"], "ops": k3["ops"],
            "share_of_bound": k3["share_of_bound"],
            "library_ms": k3["im2col_int_mm_ms"],
            "cudnn_bf16_ms": k3["cudnn_bf16_ms"], "shape": k3["x"],
            "cout": k3["cout"], "cases": k3_cases}}
    return rows, per_clip


def n_out_bytes(out_dt, shape, cout: int, stride: int) -> int:
    """Bytes of K3's output at ``shape`` -> ``cout``."""
    n, h, w, _ = shape
    return n * -(-h // stride) * -(-w // stride) * cout * out_dt.itemsize


def launch_counts(reset: bool = False) -> dict:
    """Every kernel wrapper's launch count, set to 0 first if ``reset``."""
    from bin_tpu_torch.ops import lstm_gates, pixel_shuffle, quant

    if reset:
        lstm_gates.launches = lstm_gates.bwd_launches = 0
        pixel_shuffle.launches = 0
        quant.quantize_launches = quant.conv_launches = 0
    return {"lstm_gates": lstm_gates.launches,
            "lstm_gates_bwd": lstm_gates.bwd_launches,
            "s2d_pack": pixel_shuffle.launches,
            "quantize_act": quant.quantize_launches,
            "int8_conv": quant.conv_launches}


def plain_versions():
    """A context in which the model runs every kernel's plain version."""
    import contextlib
    from unittest import mock

    from bin_tpu_torch.models import convlstm, recurrent
    from bin_tpu_torch.ops import lstm_gates, pixel_shuffle, quant

    stack = contextlib.ExitStack()
    for owner, name, plain in [
            (convlstm, "fused_lstm_gates", lstm_gates.lstm_gate_math_ref),
            (recurrent, "space_to_depth", pixel_shuffle.space_to_depth_ref),
            (quant, "quantize_act", quant.quantize_act_ref),
            (quant, "int8_conv3x3", quant.int8_conv3x3_ref)]:
        stack.enter_context(mock.patch.object(owner, name, plain))
    return stack


def serving_config(cfg, dtype: str = "bfloat16"):
    """The serving mode that ``bench_torch.py`` times, over the card's
    config, in ``dtype``."""
    from bin_tpu_torch.benchmark import (SERVING_MODE, WEIGHTS as BENCH_W,
                                         serving_overrides)
    from bin_tpu_torch.config import apply_model_overrides

    return apply_model_overrides(cfg, [*SERVING_MODE,
                                       *serving_overrides(BENCH_W),
                                       f"model.dtype={dtype}"])


def psnr_db(a, b) -> float | None:
    """PSNR of ``a`` against ``b`` at peak 1, None where they are equal."""
    import math

    mse = (a - b).double().square().mean().item()
    return None if mse == 0 else 10 * math.log10(1.0 / mse)


# Card against CPU in fp32 with TF32 off.  Float path: the two devices sum
# the convs in another order, ~1e-6 per conv.  With int8 on, such a
# difference flips the rounding of an activation at a .5 boundary now and
# then, and the flip moves a whole neighbourhood downstream: bin_tpu itself
# moves by 0.0101 when its input is scaled by 1 + 1e-7, as much as the port
# differs from it (0.0107; tests/test_torch_slice.py), hence 0.03.
CARD_VS_CPU_ATOL = {"float32": 1e-3, "int8 float32": 3e-2}


def phase_card_vs_cpu(torch, params, cfg) -> dict:
    import dataclasses

    import numpy as np

    from bin_tpu_torch import build_model

    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    x = torch.from_numpy(np.random.default_rng(0).uniform(
        0, 1, (1, 6, 64, 64, 3)).astype(np.float32))
    out = {}
    try:
        for mode, c, want in [
                ("float32", dataclasses.replace(cfg, dtype="float32"),
                 {"lstm_gates": 9, "lstm_gates_bwd": 0, "s2d_pack": 1,
                  "quantize_act": 0, "int8_conv": 0}),
                ("int8 float32", serving_config(cfg, "float32"),
                 {"lstm_gates": 9, "lstm_gates_bwd": 0, "s2d_pack": 1,
                  "quantize_act": 135, "int8_conv": 135})]:
            v_cpu, t_cpu = build_model(c, "cpu").load_params(
                params).infer_clip(x)
            model = build_model(c, "cuda").load_params(params)
            launch_counts(reset=True)
            v_gpu, t_gpu = model.infer_clip(x.cuda())
            launches = launch_counts()
            err = (v_gpu.cpu() - v_cpu).abs().max().item()
            tol = CARD_VS_CPU_ATOL[mode]
            require(list(t_cpu) == list(t_gpu),
                    f"{mode}: times {t_gpu} != CPU {t_cpu}")
            require(err <= tol, f"{mode} card vs CPU: max abs diff {err} > "
                    f"{tol}")
            require(launches == want, f"{mode} card path launches {launches}")
            out[mode] = {"shape": list(v_gpu.shape),
                         "times": [int(t) for t in t_gpu],
                         "max_abs_diff": err, "tolerance": tol,
                         "psnr_db": psnr_db(v_gpu.cpu(), v_cpu),
                         "launches": launches}
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = flags
    return out


def drive(torch, model, want: dict, card: str) -> tuple[dict, object]:
    """The main path through ``model``: ``infer_clip`` of the clip made from
    seed 0, a warm-up and TIMED_RUNS timed runs, each with every launch
    count set to 0 just before it and read just after (they must equal
    ``want``), peak memory; then once more with every kernel's plain version
    on the card, at least 40 dB from the kernels.  Returns (info, video)."""
    import numpy as np

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
        launch_counts(reset=True)
        video, times, ms = run()
        launches = launch_counts()
        require(launches == want, f"main path launches {launches}, want "
                f"{want}")
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

    # the same clip with every kernel's plain version on the card
    launch_counts(reset=True)
    with plain_versions():
        plain, _, plain_ms = run()
    require(not any(launch_counts().values()),
            "the plain rerun launched a kernel")
    psnr = psnr_db(video, plain)
    require(psnr is None or psnr >= 40, f"kernels vs plain: {psnr} dB < 40")
    ms = statistics.median(run_ms)
    return {"card": card, "dtype": str(model.dtype), "clip": list(CLIP),
            "shape": list(video.shape), "times": [int(t) for t in times],
            "finite": finite, "min": lo, "max": hi,
            "warmup_ms": warm_ms, "run_ms": run_ms, "ms_per_clip": ms,
            "fps": n_out / (ms / 1e3), "launches": launches,
            "peak_memory_bytes": peak, "plain_ms": plain_ms,
            "vs_plain_max_abs_diff": (video - plain).abs().max().item(),
            "vs_plain_psnr_db": psnr, "identical": psnr is None}, video


def per_window_launches(cfg, int8: bool) -> dict:
    """Kernel launches of one window of the pyramid, without the input
    pack: K1 once per level; in the int8 mode K3q and K3 once per int8 conv
    (per level: enc_1 and dec_1, 2 convs each, down_1, the mids, 2 each,
    and the gate conv's two halves)."""
    levels = cfg.num_levels + int(cfg.cycle_level)
    convs = levels * (4 + 1 + 2 * cfg.num_res_blocks + 2) if int8 else 0
    return {"lstm_gates": levels, "lstm_gates_bwd": 0, "s2d_pack": 0,
            "quantize_act": convs, "int8_conv": convs}


def scaled(counts: dict, n: int, **extra) -> dict:
    return {k: n * v + extra.get(k, 0) for k, v in counts.items()}


# The serving mode's video against the bf16 slice's, on the same random
# clip: the int8 rounding of 225 convs per clip.  40.47 dB on an H100 80GB
# HBM3 at 700 W; the floor leaves 3.5 dB under it.
SERVING_VS_BF16_FLOOR_DB = 37.0


def phase_serving(torch, params, cfg, card: str, bf16_video):
    """The serving mode's main path; returns (info, the serving model)."""
    from bin_tpu_torch import build_model

    model = build_model(serving_config(cfg), "cuda").load_params(params)
    windows = CLIP[1] - cfg.window_size + 1
    info, video = drive(torch, model, scaled(
        per_window_launches(cfg, True), windows, s2d_pack=1), card)
    psnr = psnr_db(video, bf16_video)
    require(psnr is not None and psnr >= SERVING_VS_BF16_FLOOR_DB,
            f"serving vs bf16: {psnr} dB < {SERVING_VS_BF16_FLOOR_DB}")
    info.update(mode="serving", config=str(model.cfg),
                vs_bf16_psnr_db=psnr, vs_bf16_floor_db=SERVING_VS_BF16_FLOOR_DB,
                vs_bf16_max_abs_diff=(video - bf16_video).abs().max().item())
    return info, model


class Rendered:
    """The samples of an eval source, rendered at once in threads (numpy
    releases the GIL in its loops), so both modes score the same clips."""

    def __init__(self, source, workers: int):
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(workers) as ex:
            self.samples = list(ex.map(source.__getitem__,
                                       range(len(source))))
        self.sample_name = source.sample_name

    def __len__(self) -> int:
        return len(self.samples)

    def __getitem__(self, i: int) -> dict:
        return self.samples[i]


def protocol_clips(cfg) -> tuple[dict, list, float]:
    """(protocol, clips, render seconds) of the release card's pinned
    protocol, every clip rendered once, in threads."""
    from bin_tpu_torch.config import Config, DataConfig
    from bin_tpu_torch.data import eval_clips
    from bin_tpu_torch.evaluation.evaluator import protocol_source

    t0 = time.perf_counter()
    protocol, source = protocol_source(Config(model=cfg, data=DataConfig()))
    clips = list(eval_clips(Rendered(source, os.cpu_count() or 1)))
    return protocol, clips, time.perf_counter() - t0


def pinned_quality(torch, cfg, model, mode: str, clips: list,
                   keys: int) -> dict:
    """``evaluate`` of ``model`` (the ``mode`` "bf16" or "serving") on the
    pinned protocol's clips, its launches exact and its psnr_overall
    within the budget of ``bin_tpu``'s figure."""
    from bin_tpu_torch.evaluation import evaluate

    windows = keys - cfg.window_size + 1
    want = scaled(per_window_launches(cfg, mode == "serving"),
                  windows * len(clips), s2d_pack=len(clips))
    torch.cuda.synchronize()
    launch_counts(reset=True)
    t = time.perf_counter()
    res = evaluate(model, clips, verbose=False)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t
    launches = launch_counts()
    require(launches == want, f"quality {mode}: launches {launches}, "
            f"want {want}")
    delta = res["psnr_overall"] - QUALITY_PSNR[mode]
    require(abs(delta) <= QUALITY_BUDGET_DB,
            f"quality {mode}: psnr_overall {res['psnr_overall']:.4f} is "
            f"{delta:+.4f} dB from {QUALITY_PSNR[mode]}")
    return {**res, "dtype": model.cfg.dtype, "int8": model.cfg.conv_int8,
            "target_psnr_overall": QUALITY_PSNR[mode], "delta_db": delta,
            "budget_db": QUALITY_BUDGET_DB, "seconds": sec,
            "launches": launches}


def phase_quality(torch, cfg, bf16_model, serving_model, protocol: dict,
                  clips: list) -> dict:
    """The pinned protocol on the release weights, through ``evaluate``, in
    bf16 and in the serving mode, on clips rendered once; then SSIM on the
    card against the CPU on the first clip's frames."""
    from bin_tpu_torch import metrics
    from bin_tpu_torch.evaluation.evaluator import clip_metrics_fn

    out = {"protocol": protocol, "card_ssim_overall": CARD_SSIM}
    for mode, model in (("bf16", bf16_model), ("serving", serving_model)):
        out[mode] = pinned_quality(torch, cfg, model, mode, clips,
                                   protocol["keys"])

    # SSIM on the card against the CPU, with TF32 allowed for cuDNN (its
    # default): the filter must not take it
    flag = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        fn, times = clip_metrics_fn(bf16_model, protocol["keys"],
                                    return_video=True)
        _, video = fn(clips[0]["blurry"], clips[0]["sharp"])
        gt = torch.from_numpy(clips[0]["sharp"][:, times])
        on_card = metrics.ssim(video, gt.cuda()).cpu()
        on_cpu = metrics.ssim(video.cpu(), gt)
    finally:
        torch.backends.cudnn.allow_tf32 = flag
    err = (on_card - on_cpu).abs().max().item()
    require(err <= SSIM_CARD_VS_CPU_ATOL,
            f"SSIM card vs CPU: max abs diff {err} > {SSIM_CARD_VS_CPU_ATOL}")
    out["ssim_card_vs_cpu"] = {"frames": int(on_card.numel()),
                               "max_abs_diff": err,
                               "tolerance": SSIM_CARD_VS_CPU_ATOL,
                               "max_ssim": on_card.max().item()}
    return out


def stream_keys(n: int, seed: int):
    import numpy as np

    return np.random.default_rng(seed).integers(
        0, 256, (n, *CLIP[2:]), dtype=np.uint8)


def stream_direct(model, keys) -> dict:
    """A direct session in the server's mode over ``keys``: {time: frame}."""
    from bin_tpu_torch.evaluation.streaming import StreamingSession

    sess = StreamingSession(model, 1, *CLIP[2:4], emit_u8=True,
                            async_drain=True)
    try:
        for key in keys:
            sess.push(key[None])
        sess.flush()
        return {t: f[0] for t, f in sess.drain()}
    finally:
        sess.close()


def key_ms_summary(ms: list) -> dict:
    """Mean, median, 90th percentile and extremes of per-key times in ms,
    over every key given."""
    return {"keys": len(ms), "mean": statistics.fmean(ms),
            "median": statistics.median(ms),
            "p90": statistics.quantiles(ms, n=10)[-1], "min": min(ms),
            "max": max(ms)}


def pinned_allocs(torch) -> tuple[int, float]:
    """(blocks, ms) the pinned host allocator has taken from CUDA so far to
    grow its pool, (0, 0.0) where this PyTorch does not count them."""
    stats = getattr(torch.cuda.memory, "host_memory_stats", dict)()
    return (stats.get("num_host_alloc", 0),
            stats.get("host_alloc_time.total", 0) / 1e3)


def stream_session(torch, model) -> dict:
    """A 720p session in the server's mode (``async_drain``, ``emit_u8``)
    over STREAM_KEYS u8 keys from seed 0, driven twice; each frame is held
    bit for bit against ``infer_clip`` of the same keys (fed as u8 / 255 in
    fp32 and quantized as the session does) as it arrives, and then
    dropped, as a server sends it and drops it (held frames would keep
    their pinned blocks, and the pinned pool would grow by one each key).

    First free-running, as the server drives it (push and poll each key,
    then flush and drain): each key's launches, read with the counts set
    to 0 just before its push; the stream's rate, the host-clock time from
    the first push to the last frame drained over all keys, the window's
    fill and the flush included; peak memory.  Then with a synchronize
    after each push: each key's latency on the host clock, for every key,
    and each slow key (over 1.5x the median) with the pinned host memory
    grown for it."""
    import numpy as np

    from bin_tpu_torch.evaluation.streaming import StreamingSession

    keys = stream_keys(STREAM_KEYS, 0)
    k = model.cfg.window_size
    step = per_window_launches(model.cfg, model.cfg.conv_int8)
    clip = torch.from_numpy(keys[None]).cuda().float() / 255.0
    video, times = model.infer_clip(clip)
    del clip
    want = torch.round(video.clamp(0, 1) * 255).to(torch.uint8).cpu().numpy()
    del video
    require(list(times) == list(range(1, 2 * STREAM_KEYS - 2)),
            f"infer_clip times {list(times)[:3]}..{list(times)[-3:]}")

    def run(sync: bool):
        sess = StreamingSession(model, 1, *CLIP[2:4], emit_u8=True,
                                async_drain=True)
        seen, diff, key_ms, grown = [], 0, [], []

        def check(frames):
            nonlocal diff
            for t, f in frames:
                seen.append(t)
                diff += int(np.count_nonzero(f[0] != want[0, t - 1]))

        try:
            torch.cuda.synchronize()
            t_start = time.perf_counter()
            for i, key in enumerate(keys):
                launch_counts(reset=True)
                before = pinned_allocs(torch)
                t0 = time.perf_counter()
                sess.push(key[None])
                if sync:
                    torch.cuda.synchronize()
                key_ms.append((time.perf_counter() - t0) * 1e3)
                after = pinned_allocs(torch)
                grown.append((after[0] - before[0], after[1] - before[1]))
                launches = launch_counts()
                expect = scaled(step, int(i >= k - 1), s2d_pack=1)
                require(launches == expect, f"streaming key {i}: launches "
                        f"{launches}, want {expect}")
                check(sess.poll())
            launch_counts(reset=True)
            sess.flush()
            check(sess.drain())
            seconds = time.perf_counter() - t_start
            require(not any(launch_counts().values()),
                    "flush launched a kernel")
        finally:
            sess.close()
        require(seen == list(times), f"streaming times {seen[:3]}.."
                f"{seen[-3:]}, {len(seen)} frames")
        require(diff == 0, f"streaming vs infer_clip: {diff} bytes differ")
        return key_ms, seconds, launches, grown

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    _, seconds, launches, free_grown = run(sync=False)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    sync_ms, _, _, sync_grown = run(sync=True)
    slow = 1.5 * statistics.median(sync_ms[k - 1:])
    return {"keys": STREAM_KEYS, "shape": list(keys.shape[1:]),
            "frames": len(times), "first_time": int(times[0]),
            "last_time": int(times[-1]),
            "bytes_differing_from_infer_clip": 0,
            "stream_seconds": seconds,
            "ms_per_key": seconds * 1e3 / STREAM_KEYS,
            "synchronized_ms": key_ms_summary(sync_ms),
            "synchronized_window_key_ms": key_ms_summary(sync_ms[k - 1:]),
            "synchronized_per_key_ms": [round(t, 2) for t in sync_ms],
            "synchronized_slow_keys": [
                {"key": i, "ms": t, "pinned_blocks_grown": g[0],
                 "pinned_grow_ms": g[1]}
                for i, (t, g) in enumerate(zip(sync_ms, sync_grown))
                if t > slow],
            "pinned_blocks_grown": {
                "free_running": sum(g[0] for g in free_grown),
                "synchronized": sum(g[0] for g in sync_grown)},
            "pinned_grow_ms": {
                "free_running": sum(g[1] for g in free_grown),
                "synchronized": sum(g[1] for g in sync_grown)},
            "launches_per_key": launches,
            "peak_memory_bytes": peak, "memory_before_bytes": base,
            "session_peak_bytes": peak - base}


def phase_streaming(torch, serving_model, bf16_model) -> dict:
    """``stream_session`` in the serving mode (what the server runs) and in
    bf16."""
    return {"serving": stream_session(torch, serving_model),
            "bf16": stream_session(torch, bf16_model)}


def phase_http(torch, model) -> dict:
    """``make_http_server`` on an ephemeral port of 127.0.0.1 with the
    serving model, a ``StreamClient`` in this process: one 720p stream of
    HTTP_KEYS u8 keys, then close; the frames and times against a direct
    session of the same keys, bit for bit; the launches of the HTTP run.

    A first stream of one window on the same connection warms the handler
    thread: the first window a fresh thread runs is slower (PyTorch keeps
    its cuDNN handles per thread), reported as
    ``cold_thread_first_window_ms``.  ``ms_per_key`` is the client's
    host-clock time from the first push to the close's return (which
    drains the last frames), over all keys."""
    import threading

    import numpy as np

    from bin_tpu_torch.serving.client import StreamClient
    from bin_tpu_torch.serving.server import FrameServer, make_http_server

    keys = stream_keys(HTTP_KEYS, 1)
    k = model.cfg.window_size
    want = stream_direct(model, keys)
    httpd = make_http_server(FrameServer(model, max_streams=1),
                             "127.0.0.1", 0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    got, per_key_ms, server_ms, cold_ms = {}, [], [], []
    try:
        with StreamClient("127.0.0.1", httpd.server_address[1],
                          timeout=300) as client:
            health = client.health()
            sid = client.open(*CLIP[2:4])
            for key in stream_keys(k, 2):
                t0 = time.perf_counter()
                client.push(sid, key)
                cold_ms.append((time.perf_counter() - t0) * 1e3)
            client.close(sid)
            torch.cuda.synchronize()
            launch_counts(reset=True)
            sid = client.open(*CLIP[2:4])
            t_start = time.perf_counter()
            for key in keys:
                t0 = time.perf_counter()
                got.update(client.push(sid, key))
                per_key_ms.append((time.perf_counter() - t0) * 1e3)
                server_ms.append(client.last_server_ms)
            t0 = time.perf_counter()
            got.update(client.close(sid))
            close_ms = (time.perf_counter() - t0) * 1e3
            seconds = time.perf_counter() - t_start
            launches = launch_counts()
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)
    windows = HTTP_KEYS - k + 1
    expect = scaled(per_window_launches(model.cfg, True), windows,
                    s2d_pack=HTTP_KEYS)
    require(launches == expect, f"http launches {launches}, want {expect}")
    require(health["platform"] == "cuda", f"healthz {health}")
    require(sorted(got) == sorted(want) == list(range(1, 2 * HTTP_KEYS - 2)),
            f"http: {len(got)} frames, direct {len(want)}")
    diff = sum(int(np.count_nonzero(got[t] != want[t])) for t in want)
    require(diff == 0, f"http vs direct session: {diff} bytes differ")
    return {"keys": HTTP_KEYS, "frames": len(got),
            "bytes_differing_from_direct": diff,
            "stream_seconds": seconds,
            "ms_per_key": seconds * 1e3 / HTTP_KEYS,
            "push_ms": key_ms_summary(per_key_ms),
            "per_key_push_ms": [round(t, 2) for t in per_key_ms],
            "close_ms": close_ms,
            "server_push_ms": key_ms_summary([p for p, _ in server_ms]),
            "server_poll_ms": key_ms_summary([q for _, q in server_ms]),
            "cold_thread_first_window_ms": cold_ms[-1],
            "launches": launches, "healthz": health}


# Phase train: config3_prf at full width (the release's recipe: EMA
# 0.999), logging every 10 steps (the host syncs there), the release
# weights as the warm start.
TRAIN_STEPS = 10
FIXED_STEPS = 30  # on one fixed batch (cheap): enough for its loss to fall
TRAIN_BATCH, TRAIN_CROP = 4, 128
TRAIN_SETS = ["optim.ema_decay=0.999", "log.log_interval_steps=10"]
# card against CPU, fp32 with TF32 off, on one clip (batch 1, 5 keys, seed
# 1): the loss within 1e-4, all gradients together within 1e-3 relative L2,
# each leaf within 1e-3, and within 2.5e-3 the leaves that a LeakyReLU input
# switching side moves: the two devices round differently, so a few of the
# clip's 45.6M LeakyReLU inputs, those within rounding of 0, take the other
# slope (3 in the cycle level, level 3, against the CPU), and each such
# switch there moves that level's small leaves by ~1e-3, as a 1 + 1e-7
# scale of the clip does on the CPU alone; with every side pinned to the
# CPU's, those leaves agree within 1e-5 (tools/train_grad_check.py).
# Measured on one H100 80GB HBM3 at 700 W: the sound readings (the card,
# and the CPU under that scale) reach 1.67e-3 on those leaves and 4.8e-4 on
# the rest; the control, the card with TF32 on, reads 3.3e-3 or more on
# those leaves, 1.02e-3 or more on the rest, and 5.1e-3 on all together,
# and must be refused
TRAIN_CPU_SHAPE = (1, 5, TRAIN_CROP)
TRAIN_LOSS_RTOL, TRAIN_GRAD_REL_L2 = 1e-4, 1e-3
TRAIN_SWITCH_LEAVES = ("level_3.", "lstm_3.", "level_1.down_0.Conv_0.",
                       "level_1.dec_0.Conv_0.")
TRAIN_SWITCH_REL_L2 = 2.5e-3
# the resumed step against the uninterrupted one: the same state and batch,
# so only cuDNN's choice of backward algorithms (not deterministic) and
# TF32 differ; the loss within 1e-4, the parameters' move within 1e-2
RESUME_LOSS_RTOL, RESUME_MOVE_REL_L2 = 1e-4, 1e-2
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "build")


def per_step_launches(cfg) -> dict:
    """Kernel launches of one train step: K1 once per level and window
    (twice with remat), K2 for the clip and its ground truth, and K1b once
    per level and window but the last: the last window's new carry reaches
    no loss, so autograd runs no backward for its gate update."""
    levels = cfg.model.num_levels + int(cfg.model.cycle_level)
    windows = cfg.data.seq_len - cfg.model.window_size + 1
    return {"lstm_gates": levels * windows * (2 if cfg.model.remat else 1),
            "lstm_gates_bwd": levels * (windows - 1), "s2d_pack": 2,
            "quantize_act": 0, "int8_conv": 0}


def rel_l2(a, b) -> float:
    return ((a.double() - b.double()).norm()
            / b.double().norm().clamp_min(1e-30)).item()


def train_clip(torch, seed: int = 1, shape=TRAIN_CPU_SHAPE):
    """A fixed float clip (blurry, sharp) in [0, 1] made from ``seed``."""
    import numpy as np

    b, k, hw = shape
    rng = np.random.default_rng(seed)
    blurry = rng.uniform(0, 1, (b, k, hw, hw, 3)).astype(np.float32)
    sharp = rng.uniform(0, 1, (b, 2 * k - 1, hw, hw, 3)).astype(np.float32)
    return torch.from_numpy(blurry), torch.from_numpy(sharp)


def clip_grads(torch, params, cfg, dev: str, blurry, sharp,
               tf32: bool = False) -> dict:
    """The loss of one clip and its gradient leaf by leaf (on the CPU), from
    the release weights on ``dev``, with cuDNN's and matmul's TF32 set to
    ``tf32`` for the call and restored after; on the card also the kernel
    launches it made."""
    from bin_tpu_torch import build_model

    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        model = build_model(cfg.model, dev).train_params(params)
        launch_counts(reset=True)
        t0 = time.perf_counter()
        loss, _ = model.loss_clip(blurry, sharp, cfg.loss)
        loss.backward()
        if dev == "cuda":
            torch.cuda.synchronize()
        return {"loss": loss.item(), "seconds": time.perf_counter() - t0,
                "launches": launch_counts(),
                "grads": {n: p.grad.detach().cpu()
                          for n, p in model.module.named_parameters()}}
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = flags


def grad_readings(torch, run: dict, ref: dict) -> dict:
    """``run`` against ``ref``: the loss's relative difference, all
    gradients together and each leaf in relative L2."""
    names = list(ref["grads"])
    return {"loss_rel_diff": abs(run["loss"] - ref["loss"]) / abs(ref["loss"]),
            "grad_rel_l2": rel_l2(
                torch.cat([run["grads"][n].flatten() for n in names]),
                torch.cat([ref["grads"][n].flatten() for n in names])),
            "leaves": {n: rel_l2(run["grads"][n], ref["grads"][n])
                       for n in names}}


def over_train_bounds(reading: dict, grad_bound: float = TRAIN_GRAD_REL_L2,
                      leaf=None) -> list:
    """What of a card-vs-CPU reading is over its bound: the loss over
    TRAIN_LOSS_RTOL, all gradients together over ``grad_bound``, each leaf
    over ``leaf`` (a bound for every leaf; ``leaf_bound``'s by default)."""
    over = [f"loss {reading['loss_rel_diff']}"] if (
        reading["loss_rel_diff"] > TRAIN_LOSS_RTOL) else []
    if reading["grad_rel_l2"] > grad_bound:
        over.append(f"gradients {reading['grad_rel_l2']}")
    return over + [f"{n} {v}" for n, v in reading["leaves"].items()
                   if v > (leaf_bound(n) if leaf is None else leaf)]


def leaf_bound(name: str) -> float:
    """The card-vs-CPU bound of gradient leaf ``name``."""
    return (TRAIN_SWITCH_REL_L2 if name.startswith(TRAIN_SWITCH_LEAVES)
            else TRAIN_GRAD_REL_L2)


def train_card_vs_cpu(torch, params, cfg) -> dict:
    """The loss and gradient of one clip on the card (kernels) against the
    CPU (plain versions), fp32 with TF32 off; then the control, the card
    with TF32 on, which the same bounds must refuse."""
    import dataclasses

    blurry, sharp = train_clip(torch)
    b, k = blurry.shape[:2]
    c = dataclasses.replace(cfg, data=dataclasses.replace(
        cfg.data, seq_len=k, batch_size=b))
    cpu = clip_grads(torch, params, cfg, "cpu", blurry, sharp)
    card = clip_grads(torch, params, cfg, "cuda", blurry, sharp)
    want = per_step_launches(c)
    require(card["launches"] == want, f"card loss_clip launches "
            f"{card['launches']}, want {want}")
    sound = grad_readings(torch, card, cpu)
    over = over_train_bounds(sound)
    require(not over, f"train card vs CPU over the bounds: {over}")
    control = grad_readings(torch, clip_grads(
        torch, params, cfg, "cuda", blurry, sharp, tf32=True), cpu)
    refused = over_train_bounds(control)
    require(bool(refused), "train card vs CPU: the bounds pass the control "
            f"(TF32 on): gradients {control['grad_rel_l2']}")
    worst = max((v, n) for n, v in sound["leaves"].items())

    def per_bound(reading, pick):
        return {str(bound): pick(v for n, v in reading["leaves"].items()
                                 if leaf_bound(n) == bound)
                for bound in (TRAIN_GRAD_REL_L2, TRAIN_SWITCH_REL_L2)}
    return {"shape": list(blurry.shape), "loss_cpu": cpu["loss"],
            "loss_card": card["loss"],
            "loss_rel_diff": sound["loss_rel_diff"],
            "loss_rtol": TRAIN_LOSS_RTOL, "grad_rel_l2": sound["grad_rel_l2"],
            "grad_rel_l2_bound": TRAIN_GRAD_REL_L2, "worst_leaf": worst[1],
            "worst_leaf_rel_l2": worst[0],
            "worst_leaf_bound": leaf_bound(worst[1]),
            "largest_leaf_by_bound": per_bound(sound, max),
            "control_tf32": {"loss_rel_diff": control["loss_rel_diff"],
                             "grad_rel_l2": control["grad_rel_l2"],
                             "least_leaf_by_bound": per_bound(control, min),
                             "over": len(refused), "over_first": refused[:5]},
            "leaves": len(cpu["grads"]), "launches": card["launches"],
            "seconds_cpu": cpu["seconds"], "seconds_card": card["seconds"]}


@contextlib.contextmanager
def kink_record(record: dict, pin: dict | None = None):
    """Records, in call order, every Charbonnier difference, every
    LeakyReLU input's sign and every QAT activation quantizer's (q, scale),
    each sign and q with the model's top-level module that made it
    (``level_3``, ``lstm_2``, ...).  With ``pin`` (an earlier run's
    record), each LeakyReLU takes the slope of that run's side and each
    activation quantizer returns that run's (q, scale): the discrete
    decisions of the two runs are then the same, and what differs is the
    arithmetic between them."""
    from unittest import mock

    import torch
    import torch.nn.functional as F

    import bin_tpu_torch
    from bin_tpu_torch import losses
    from bin_tpu_torch.ops import quant

    charb, leaky, build = losses.charbonnier, F.leaky_relu, \
        bin_tpu_torch.build_model
    quantize = quant.quantize_symmetric
    names, where = {}, [""]
    record.setdefault("quant", [])

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
        side = pin["leaky"][len(record["leaky"]) - 1][1].to(
            x.device).view_as(x)
        return torch.where(side, x, x * slope)

    def quantize_symmetric(x, dim=None, mse_clip=False):
        q, scale = quantize(x, dim, mse_clip)
        if dim is not None:  # a weight: the same on every device
            return q, scale
        record["quant"].append((where[0], q.flatten().cpu(), scale.cpu()))
        if pin is not None:
            _, q, scale = pin["quant"][len(record["quant"]) - 1]
            q, scale = q.to(x.device).view(x.shape), scale.to(x.device)
        return q, scale

    hook = torch.nn.modules.module.register_module_forward_pre_hook(
        top_module)
    try:
        with mock.patch.object(losses, "charbonnier", charbonnier), \
                mock.patch.object(F, "leaky_relu", leaky_relu), \
                mock.patch.object(quant, "quantize_symmetric",
                                  quantize_symmetric), \
                mock.patch.object(bin_tpu_torch, "build_model", build_model):
            yield
    finally:
        hook.remove()


def kink_switches(torch, a: dict, b: dict) -> dict:
    """What switched side of a kink between records ``a`` and ``b``: loss
    terms, LeakyReLU inputs, and quantized activations that moved."""
    diff_a, diff_b = torch.cat(a["diff"]), torch.cat(b["diff"])
    leaky: dict[str, int] = {}
    for (where, sa), (_, sb) in zip(a["leaky"], b["leaky"]):
        n = int((sa != sb).sum())
        if n:
            leaky[where] = leaky.get(where, 0) + n
    moved: dict[str, int] = {}
    for (where, qa, _), (_, qb, _) in zip(a["quant"], b["quant"]):
        n = int((qa != qb).sum())
        if n:
            moved[where] = moved.get(where, 0) + n
    return {"loss_terms": diff_a.numel(),
            "loss_terms_within_1e-5": int((diff_a.abs() < 1e-5).sum()),
            "loss_terms_sign_switched": int(
                ((diff_a > 0) != (diff_b > 0)).sum()),
            "leaky_inputs": sum(s.numel() for _, s in a["leaky"]),
            "leaky_sign_switched": sum(leaky.values()),
            "leaky_sign_switched_by_module": leaky,
            "quantized_activations": sum(q.numel() for _, q, _ in a["quant"]),
            "quantized_moved": sum(moved.values()),
            "quantized_moved_by_module": moved}


def timed_steps(torch, make_step, record: list):
    """``make_train_step`` whose steps record CUDA events around each step,
    the launches and the host syncs inside it, and its loss (kept on the
    card)."""
    import warnings

    def make(model, cfg, plan=None):
        inner = make_step(model, cfg, plan)

        def step(state, batch):
            before = launch_counts()
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    ev[0].record()
                    state, aux = inner(state, batch)
                    ev[1].record()
                finally:
                    torch.cuda.set_sync_debug_mode("default")
            after = launch_counts()
            record.append({
                "events": ev, "loss": aux["loss_total"],
                "grad_norm": aux["grad_norm"],
                "launches": {k: after[k] - before[k] for k in after},
                "syncs": sum("synchroniz" in str(w.message)
                             for w in caught)})
            return state, aux
        return step
    return make


def step_summary(torch, record: list, cfg, first: int = 4) -> dict:
    """ms per step (CUDA events) over steps first+1..: each step's own
    interval, and from one step's start to the next (loader waits and
    work between steps in, so a median that an eval between two steps does
    not move); the device span of those steps, steps/s and input frames/s
    from it."""
    ms = [r["events"][0].elapsed_time(r["events"][1]) for r in
          record[first:]]
    starts = [a["events"][0].elapsed_time(b["events"][0])
              for a, b in zip(record[first:], record[first + 1:])]
    span = record[first]["events"][0].elapsed_time(record[-1]["events"][1])
    n = len(record) - first
    frames = cfg.data.batch_size * cfg.data.seq_len
    return {"steps_timed": [first + 1, len(record)],
            "ms_per_step_median": statistics.median(ms),
            "ms_per_step_min": min(ms), "ms_per_step_max": max(ms),
            "ms_per_step": ms, "span_ms": span,
            "start_to_start_ms_median": statistics.median(starts),
            "steps_per_s": n / (span / 1e3),
            "input_frames_per_s": n * frames / (span / 1e3),
            "steps_per_s_from_median": 1e3 / statistics.median(ms)}


def phase_train(torch, params, card: str) -> dict:
    import shutil
    import tempfile
    from unittest import mock

    import numpy as np

    from bin_tpu_torch import build_model
    from bin_tpu_torch.config import get_config
    from bin_tpu_torch.data.pipeline import train_iterator
    from bin_tpu_torch.training import checkpoint as ckpt
    from bin_tpu_torch.training import trainer
    from bin_tpu_torch.training.state import create_train_state, warm_start
    from bin_tpu_torch.weights import export_weights, load_weights

    cfg = get_config("config3_prf", TRAIN_SETS)
    require((cfg.data.batch_size, cfg.data.crop_size, cfg.data.seq_len,
             cfg.model.dtype) == (TRAIN_BATCH, (TRAIN_CROP, TRAIN_CROP), 6,
                                  "float32"), f"config3_prf is {cfg}")
    info = {"card": card, "preset": cfg.preset, "sets": TRAIN_SETS,
            "batch": cfg.data.batch_size, "crop": list(cfg.data.crop_size),
            "seq_len": cfg.data.seq_len, "dtype": cfg.model.dtype,
            "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
            "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32}
    info["card_vs_cpu"] = train_card_vs_cpu(torch, params, cfg)
    want = per_step_launches(cfg)
    os.makedirs(BUILD_DIR, exist_ok=True)
    wd = tempfile.mkdtemp(prefix="smoke_train_", dir=BUILD_DIR)
    try:
        # 1. the main path: train(), 10 steps from the release weights
        record: list = []
        real = trainer.make_train_step
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        launch_counts(reset=True)
        t0 = time.perf_counter()
        with mock.patch.object(trainer, "make_train_step",
                               timed_steps(torch, real, record)):
            model, state = trainer.train(cfg, wd, TRAIN_STEPS, WEIGHTS,
                                         "cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = launch_counts()
        peak = torch.cuda.max_memory_allocated()
        require(launches == scaled(want, TRAIN_STEPS),
                f"train launches {launches}, want {TRAIN_STEPS} x {want}")
        for i, r in enumerate(record):
            require(r["launches"] == want,
                    f"step {i + 1} launches {r['launches']}, want {want}")
        losses = [r["loss"].item() for r in record]
        require(all(math.isfinite(v) for v in losses),
                f"non-finite train losses {losses}")
        skipped = int(state.total_notfinite)
        require(skipped == 0, f"{skipped} steps skipped")
        require(state.step == TRAIN_STEPS and int(state.count) == TRAIN_STEPS,
                f"step {state.step}, count {int(state.count)}")
        info["train"] = {
            **step_summary(torch, record, cfg), "wall_s": wall,
            "losses": losses,
            "grad_norms": [r["grad_norm"].item() for r in record],
            "launches": launches, "launches_per_step": want,
            "host_syncs_in_step": [r["syncs"] for r in record],
            "peak_memory_bytes": peak, "skipped_steps": skipped,
            "checkpoints": sorted(os.listdir(os.path.join(
                wd, cfg.checkpoint.directory)))}

        # 2. the uninterrupted next step on the stream's first batch
        # (a resumed run starts its stream again from the seed)
        it = train_iterator(trainer._make_source(cfg), cfg.data.batch_size,
                            cfg.data.crop_size, seed=cfg.seed,
                            random_flip=cfg.data.random_flip,
                            keep_u8=cfg.data.transfer_u8)
        batch0 = {k: torch.from_numpy(v).cuda() for k, v in next(it).items()}
        it.close()
        p30 = state.params.clone()
        state, aux = real(model, cfg)(state, batch0)
        loss_u = aux["loss_total"].item()
        move_u = state.params - p30
        del model, state, aux

        # 3. resumed from the checkpoint for one step through train()
        model, state = trainer.train(cfg, wd, TRAIN_STEPS + 1, "", "cuda")
        with open(os.path.join(wd, cfg.log.jsonl_path)) as f:
            last = [json.loads(line) for line in f][-1]
        require(last["step"] == TRAIN_STEPS + 1, f"resume logged {last}")
        move_r = state.params - p30
        loss_rel = abs(last["loss_total"] - loss_u) / abs(loss_u)
        move_rel = rel_l2(move_r, move_u)
        require(loss_rel <= RESUME_LOSS_RTOL,
                f"resumed loss {last['loss_total']} vs {loss_u}")
        require(move_rel <= RESUME_MOVE_REL_L2,
                f"resumed move rel L2 {move_rel}")
        del model, state, p30, move_u, move_r

        # 4. export the resumed run's EMA as a release file; infer with it
        npz = os.path.join(wd, "exported.npz")
        export_weights(npz, ckpt.restore_params(
            os.path.join(wd, cfg.checkpoint.directory), ema=True), cfg.model,
            {"preset": cfg.preset, "ema": True, "steps": TRAIN_STEPS + 1},
            store_dtype="float16")
        exp_params, exp_cfg, _ = load_weights(npz)
        clip = torch.from_numpy(np.random.default_rng(3).uniform(
            0, 1, (1, 8, 256, 256, 3)).astype(np.float32)).cuda()
        video, times = build_model(exp_cfg, "cuda").load_params(
            exp_params).infer_clip(clip)
        ref, _ = build_model(exp_cfg, "cuda").load_params(params).infer_clip(
            clip)
        finite = bool(torch.isfinite(video).all())
        require(finite and tuple(video.shape) == (1, 13, 256, 256, 3),
                f"exported weights: video {tuple(video.shape)}, finite "
                f"{finite}")
        info["resume"] = {
            "loss_uninterrupted": loss_u, "loss_resumed": last["loss_total"],
            "loss_rel_diff": loss_rel, "loss_rtol": RESUME_LOSS_RTOL,
            "move_rel_l2": move_rel, "move_rel_l2_bound": RESUME_MOVE_REL_L2,
            "export_bytes": os.path.getsize(npz),
            "exported_infer_clip": {
                "shape": list(video.shape), "times": [int(t) for t in times],
                "finite": finite, "min": video.min().item(),
                "max": video.max().item(),
                "vs_release_psnr_db": psnr_db(video, ref)}}
        del video, ref

        # 5. 30 steps on one fixed batch from the release weights
        model = build_model(cfg.model, "cuda")
        state = warm_start(create_train_state(cfg, model), params)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fixed: list = []
        step = timed_steps(torch, real, fixed)(model, cfg)
        for _ in range(FIXED_STEPS):
            state, _ = step(state, batch0)
        losses = [r["loss"].item() for r in fixed]
        require(losses[-1] < losses[0], f"fixed batch: loss {losses[0]} -> "
                f"{losses[-1]}")
        info["fixed_batch"] = {**step_summary(torch, fixed, cfg),
                               "losses": losses, "peak_memory_bytes":
                               torch.cuda.max_memory_allocated()}
        del model, state
    finally:
        shutil.rmtree(wd, ignore_errors=True)
    return info


# Phase int8_release: the chain that makes an int8 release, on the card.
# (a) tools/calibrate_int8.py's defaults on the release weights: 8 clips of
# 12 keys at 256x256, seed 1234, bf16, against the committed sidecar, which
# was calibrated on the TPU; the fresh sidecar's serving quality on the
# pinned protocol.
RELEASE_SCALES = os.path.join(os.path.dirname(WEIGHTS),
                              "prf_ema_r4.scales.npz")
# The card's bf16 convs round at other places than the TPU's, so each
# activation maximum moves by a few bf16 steps (2^-8 = 0.39 %): measured
# 1.57 % at most (level_2/dec_0/Conv_1), median 0.36 %, on an H100 80GB
# HBM3 at 700 W; the bound is twice the largest
CALIB_REL_BOUND = 3e-2
# (b) one QAT clip, card against CPU (fp32, TF32 off; batch 1, 128x128, 5
# keys, QAT at min_cin 256): the loss within TRAIN_LOSS_RTOL; the gradients
# (all together, each leaf; relative L2) within QAT_FREE as they come, and
# within phase train's bounds with the CPU's quantizer outputs and
# LeakyReLU sides pinned.  QAT's gradient is chaotic in its quantizers: a 1 + 1e-7 scale
# of the clip moves 3.7-4.0M of its 28.3M quantized activations on the
# CPU, and the CPU's own gradient by 1.99-2.22e-2 (leaves up to 0.22);
# the card reads 2.19-2.44e-2, TF32 on 2.00-2.40e-2 (tools/
# train_grad_check.py, seeds 1-3; NVIDIA H100 80GB HBM3, 700 W): QAT_FREE
# is twice the largest sound reading, and cannot refuse the control.
QAT_FREE = (5e-2, 0.5)
# One fake_quant_conv at the serving path's widest shape against
# int8_conv (the dynamic scale): equal where the integer sums stay below
# 2^24, so within fp32 rounding of the output's magnitude.
QAT_MIN_CIN = 256
FQ_CONV_REL_ATOL = 2.0 ** -22
# (c) tools/qat_finetune.sh's settings through train(): config3_prf, QAT at
# min_cin 256, bf16, remat, EMA 0.999, lr 1e-5 without decay, from the
# release, 10 steps, the eval every 10 steps on 2 clips at 256x256 (pinned:
# the preset's own eval size is 352x640), the watchdog on
QAT_MODE = ["model.conv_int8_qat=true", f"model.conv_int8_min_cin={QAT_MIN_CIN}"]
QAT_SETS = [*QAT_MODE, "model.dtype=bfloat16", "model.remat=true",
            "optim.ema_decay=0.999", "optim.learning_rate=1e-5",
            "optim.lr_decay_steps=1000000", "log.log_interval_steps=10",
            "log.eval_interval_steps=10", "log.eval_clips=2",
            "data.eval_size=256,256", "log.stall_timeout_s=600"]
# (d) bf16 training on the fixed batch of phase train; the bf16 gradient of
# the card-vs-CPU clip against the fp32 one (TF32 off), both on the card:
# bf16's rounding, measured 2.07e-2 relative L2 (the worst leaf 0.126,
# level_3.down_1.Conv_0.weight) on an H100 80GB HBM3 at 700 W; set at
# 5e-2 before that reading
BF16_VS_FP32_REL_L2 = 5e-2
# (e) the fine-tune's best.npz calibrated on 2 clips, served at 720p


def calibrate_cli(argv: list[str]) -> dict:
    """``python -m bin_tpu_torch.calibrate`` in this process; its JSON
    line, its per-key listing kept off this script's output."""
    import contextlib
    import io

    from bin_tpu_torch import calibrate

    with contextlib.redirect_stdout(io.StringIO()), \
            contextlib.redirect_stderr(io.StringIO()):
        return calibrate.main(argv)


def fake_quant_conv_check(torch, cfg) -> dict:
    """``fake_quant_conv`` of a bf16 (3, 180, 320, 256) input -> 256, the
    serving path's widest int8 conv, against ``int8_conv`` (K3q + K3) with
    the dynamic scale, under TF32 on (PyTorch's default) and off."""
    from bin_tpu_torch.ops import quant

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)
    c = cfg.base_features * cfg.channel_mult[1]
    h, w = CLIP[2] // (2 * cfg.stem_factor), CLIP[3] // (2 * cfg.stem_factor)
    x = (torch.randn(3, h, w, c, device=dev, generator=gen)
         * 0.5).to(torch.bfloat16)
    weight = torch.randn(c, c, 3, 3, device=dev, generator=gen) * 0.05
    bias = torch.randn(c, device=dev, generator=gen)
    qw, ks = quant.quantize_weight(weight)
    out = {"x": list(x.shape), "cout": c}
    flag = torch.backends.cudnn.allow_tf32
    try:
        with torch.no_grad():
            deployed = quant.int8_conv(x, qw, ks, bias, 1, (1, 1), None,
                                       torch.float32)
            for tf32 in (True, False):
                torch.backends.cudnn.allow_tf32 = tf32
                fq = quant.fake_quant_conv(x, weight, bias, 1, (1, 1))
                diff = (fq - deployed).abs()
                bound = FQ_CONV_REL_ATOL * deployed.abs().max().item()
                err = diff.max().item()
                require(err <= bound, f"fake_quant_conv (TF32 {tf32}) vs "
                        f"int8_conv: {err} > {bound}")
                out[f"tf32_{str(tf32).lower()}"] = {
                    "max_abs_diff": err, "bound": bound,
                    "equal_share": (diff == 0).float().mean().item()}
    finally:
        torch.backends.cudnn.allow_tf32 = flag
    return out


def qat_card_vs_cpu(torch, params) -> dict:
    """One QAT clip's loss and gradient, card against CPU in fp32 with TF32
    off.  Free, the two runs' quantizers decide apart and the card reads as
    far from the CPU as the CPU from itself under a 1 + 1e-7 scale of the
    clip, and as the card with TF32 on: held to the QAT_FREE bounds.  With
    every activation quantizer's (q, scale) and every LeakyReLU's side
    pinned to the CPU run's (``kink_record``), held to phase ``train``'s
    bounds (``over_train_bounds``), which the control, the card with TF32
    on and pinned alike, must exceed."""
    import dataclasses

    from bin_tpu_torch.config import get_config

    cfg = get_config("config3_prf", [*TRAIN_SETS, *QAT_MODE])
    blurry, sharp = train_clip(torch)
    b, k = blurry.shape[:2]
    c = dataclasses.replace(cfg, data=dataclasses.replace(
        cfg.data, seq_len=k, batch_size=b))
    rec = {key: {"diff": [], "leaky": []} for key in ("cpu", "card")}
    with kink_record(rec["cpu"]):
        cpu = clip_grads(torch, params, cfg, "cpu", blurry, sharp)
    with kink_record(rec["card"]):
        card = clip_grads(torch, params, cfg, "cuda", blurry, sharp)
    want = per_step_launches(c)
    require(card["launches"] == want, f"QAT card loss_clip launches "
            f"{card['launches']}, want {want}")
    runs = {"card": card, "control_tf32": clip_grads(
        torch, params, cfg, "cuda", blurry, sharp, tf32=True)}
    for key, tf32 in (("card_pinned", False), ("control_tf32_pinned", True)):
        rec[key] = {"diff": [], "leaky": []}
        with kink_record(rec[key], pin=rec["cpu"]):
            runs[key] = clip_grads(torch, params, cfg, "cuda", blurry, sharp,
                                   tf32=tf32)
    read = {key: grad_readings(torch, r, cpu) for key, r in runs.items()}
    free = over_train_bounds(read["card"], *QAT_FREE)
    pinned = over_train_bounds(read["card_pinned"])
    refused = over_train_bounds(read["control_tf32_pinned"])

    def summary(reading):
        worst = max((v, n) for n, v in reading["leaves"].items())
        return {"loss_rel_diff": reading["loss_rel_diff"],
                "grad_rel_l2": reading["grad_rel_l2"],
                "worst_leaf": worst[1], "worst_leaf_rel_l2": worst[0],
                "least_leaf_rel_l2": min(reading["leaves"].values())}
    out = {"sets": QAT_MODE, "shape": list(blurry.shape),
           "loss_cpu": cpu["loss"], "loss_card": card["loss"],
           "loss_rtol": TRAIN_LOSS_RTOL, "free_bounds": QAT_FREE,
           "pinned_bounds": [TRAIN_GRAD_REL_L2, TRAIN_SWITCH_REL_L2],
           "kinks_card_vs_cpu": kink_switches(torch, rec["cpu"], rec["card"]),
           "kinks_pinned_card_vs_cpu": kink_switches(torch, rec["cpu"],
                                                     rec["card_pinned"]),
           **{key: summary(r) for key, r in read.items()},
           "control_tf32_free": (
               "not separable: the CPU's own spread under a 1 + 1e-7 scale "
               "of the clip reaches the control's reading (tools/"
               "train_grad_check.py), as the quantizers' round(x / s) "
               "cascade: a moved q shifts its neighbourhood downstream by a "
               "quantization step, and millions of quantized activations "
               "move; the pinned control is refused instead"),
           "over_free": free[:8], "over_pinned": pinned[:8],
           "control_pinned_over": len(refused), "launches": card["launches"],
           "seconds_cpu": cpu["seconds"], "seconds_card": card["seconds"]}
    require(not free, f"QAT card vs CPU over the free bounds: {free[:8]}")
    require(not pinned, f"QAT card vs CPU pinned over the bounds: "
            f"{pinned[:8]}")
    require(bool(refused), "QAT card vs CPU pinned: the bounds pass the "
            "control (TF32 on): gradients "
            f"{read['control_tf32_pinned']['grad_rel_l2']}")
    return out


def phase_int8_release(torch, params, cfg, card: str, protocol: dict,
                       clips: list, fp32_fixed: dict) -> dict:
    """The int8 release chain: (a) calibrate the release, compare with the
    committed sidecar, serve the pinned protocol with the fresh one; (b) a
    QAT clip card against CPU, and fake_quant_conv against int8_conv; (c)
    the QAT fine-tune through ``train``; (d) bf16 training on a fixed
    batch; (e) calibrate (c)'s best.npz and serve it at 720p."""
    import dataclasses
    import shutil
    import tempfile
    from unittest import mock

    import numpy as np

    from bin_tpu_torch import build_model
    from bin_tpu_torch.benchmark import (SERVING_MODE, check_sidecar,
                                         serving_overrides)
    from bin_tpu_torch.config import apply_model_overrides, get_config
    from bin_tpu_torch.models.layers import QATConv
    from bin_tpu_torch.data.pipeline import train_iterator
    from bin_tpu_torch.ops.quant import load_act_scales
    from bin_tpu_torch.training import trainer
    from bin_tpu_torch.training.state import create_train_state, warm_start
    from bin_tpu_torch.weights import card_config, load_weights, read_card

    info = {"card": card}
    os.makedirs(BUILD_DIR, exist_ok=True)
    wd = tempfile.mkdtemp(prefix="smoke_release_", dir=BUILD_DIR)
    try:
        # (a) the release, at the tool's defaults
        fresh = os.path.join(wd, "prf_ema_r4.scales.npz")
        rec = calibrate_cli(["--checkpoint", WEIGHTS, "--out", fresh])
        mine, theirs = load_act_scales(fresh), load_act_scales(RELEASE_SCALES)
        require(sorted(mine) == sorted(theirs) and len(mine) == 63,
                f"calibrated keys {len(mine)} vs the committed "
                f"{len(theirs)}")
        rel = {k: abs(mine[k] / theirs[k] - 1) for k in theirs}
        worst = max(rel, key=rel.get)
        # named as a user names it, through the entries' provenance check
        scfg = apply_model_overrides(cfg, [
            *SERVING_MODE, *serving_overrides(WEIGHTS),
            f"model.conv_int8_static={fresh}"])
        check_sidecar(scfg, WEIGHTS)
        model = build_model(scfg, "cuda").load_params(params)
        require(model.cfg.conv_int8_static == fresh,
                f"the fresh sidecar was not taken: {model.cfg}")
        quality = pinned_quality(torch, cfg, model, "serving", clips,
                                 protocol["keys"])
        del model
        info["calibrate_release"] = {
            **rec, "keys_equal_committed": True,
            "max_rel_diff": rel[worst], "max_rel_diff_key": worst,
            "rel_diff_bound": CALIB_REL_BOUND,
            "median_rel_diff": statistics.median(rel.values()),
            "rel_diff": rel, "serving_quality": quality}
        require(rel[worst] <= CALIB_REL_BOUND, f"calibrated scale {worst} "
                f"{rel[worst]} from the committed one")

        # (b) QAT on the card against the CPU; fake_quant_conv at 720p
        info["qat_card_vs_cpu"] = qat_card_vs_cpu(torch, params)
        info["fake_quant_conv"] = fake_quant_conv_check(torch, cfg)

        # (c) the QAT fine-tune through train()
        qcfg = get_config("config3_prf", QAT_SETS)
        want = per_step_launches(qcfg)
        record: list = []
        real = trainer.make_train_step
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        launch_counts(reset=True)
        t0 = time.perf_counter()
        with mock.patch.object(trainer, "make_train_step",
                               timed_steps(torch, real, record)):
            model, state = trainer.train(qcfg, wd, TRAIN_STEPS, WEIGHTS,
                                         "cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = launch_counts()
        peak = torch.cuda.max_memory_allocated()
        for i, r in enumerate(record):
            require(r["launches"] == want,
                    f"QAT step {i + 1} launches {r['launches']}, want {want}")
        eval_keys = max(qcfg.data.eval_num_keys, qcfg.model.window_size + 2)
        evals = TRAIN_STEPS // qcfg.log.eval_interval_steps
        n_eval = qcfg.log.eval_clips
        eval_want = scaled(per_window_launches(qcfg.model, False),
                           (eval_keys - qcfg.model.window_size + 1) * n_eval
                           * evals, s2d_pack=n_eval * evals)
        require(launches == {k: TRAIN_STEPS * want[k] + eval_want[k]
                             for k in want},
                f"QAT run launches {launches}: {TRAIN_STEPS} x {want} + "
                f"evals {eval_want}")
        losses = [r["loss"].item() for r in record]
        require(all(math.isfinite(v) for v in losses),
                f"non-finite QAT losses {losses}")
        skipped = int(state.total_notfinite)
        require(skipped == 0 and state.step == TRAIN_STEPS,
                f"{skipped} QAT steps skipped, step {state.step}")
        syncs = [r["syncs"] for r in record]
        require(not any(syncs[1:]), f"host syncs in QAT steps {syncs}")
        best = os.path.join(wd, "best.npz")
        meta = read_card(best)["metadata"]
        with open(os.path.join(wd, qcfg.log.jsonl_path)) as f:
            evals_logged = [r for r in map(json.loads, f)
                            if "eval_psnr_overall" in r]
        psnrs = [r["eval_psnr_overall"] for r in evals_logged]
        require(len(psnrs) == evals and meta["psnr_overall"] == max(psnrs)
                and meta["ema"] is True, f"best.npz card {meta}, evals "
                f"{psnrs}")
        info["qat_finetune"] = {
            "sets": QAT_SETS, **step_summary(torch, record, qcfg),
            "wall_s": wall, "losses": losses, "launches": launches,
            "launches_per_step": want, "launches_of_evals": eval_want,
            "host_syncs_in_step": syncs, "peak_memory_bytes": peak,
            "skipped_steps": skipped, "eval_psnr_overall": psnrs,
            "best_card": meta}
        del model, state

        # (d) bf16 training on phase train's fixed batch
        bcfg = get_config("config3_prf", [*TRAIN_SETS, "model.dtype=bfloat16"])
        it = train_iterator(trainer._make_source(bcfg), bcfg.data.batch_size,
                            bcfg.data.crop_size, seed=bcfg.seed,
                            random_flip=bcfg.data.random_flip,
                            keep_u8=bcfg.data.transfer_u8)
        batch0 = {k: torch.from_numpy(v).cuda() for k, v in next(it).items()}
        it.close()
        model = build_model(bcfg.model, "cuda")
        state = warm_start(create_train_state(bcfg, model), params)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fixed: list = []
        step = timed_steps(torch, real, fixed)(model, bcfg)
        for _ in range(FIXED_STEPS):
            state, _ = step(state, batch0)
        losses = [r["loss"].item() for r in fixed]
        peak = torch.cuda.max_memory_allocated()
        require(all(math.isfinite(v) for v in losses)
                and int(state.total_notfinite) == 0,
                f"bf16 fixed batch: losses {losses}")
        require(all(r["launches"] == per_step_launches(bcfg) for r in fixed),
                f"bf16 step launches {[r['launches'] for r in fixed]}")
        del model, state, batch0
        blurry, sharp = train_clip(torch)
        g16 = clip_grads(torch, params, bcfg, "cuda", blurry, sharp)
        g32 = clip_grads(torch, params, dataclasses.replace(
            bcfg, model=dataclasses.replace(bcfg.model, dtype="float32")),
            "cuda", blurry, sharp)
        vs = grad_readings(torch, g16, g32)
        worst = max((v, n) for n, v in vs["leaves"].items())
        info["bf16_train"] = {
            **step_summary(torch, fixed, bcfg), "losses": losses,
            "peak_memory_bytes": peak,
            "fp32_fixed_batch_ms_per_step_median":
                fp32_fixed["ms_per_step_median"],
            "fp32_peak_memory_bytes": fp32_fixed.get("peak_memory_bytes"),
            "vs_fp32": {"loss_rel_diff": vs["loss_rel_diff"],
                        "grad_rel_l2": vs["grad_rel_l2"],
                        "grad_rel_l2_bound": BF16_VS_FP32_REL_L2,
                        "worst_leaf": worst[1], "worst_leaf_rel_l2": worst[0]}}
        require(vs["grad_rel_l2"] <= BF16_VS_FP32_REL_L2,
                f"bf16 vs fp32 gradients {vs['grad_rel_l2']}")

        # (e) calibrate best.npz (2 clips), serve it at 720p
        best_scales = os.path.join(wd, "best.scales.npz")
        rec = calibrate_cli(["--checkpoint", best, "--out", best_scales,
                             "--clips", "2"])
        # served as bin_tpu_torch.serving.server and the evaluator's
        # --serving serve it: the card's config (which keeps the QAT flag
        # of training), the serving mode, the sidecar named by --set, and
        # the entries' provenance check, which must refuse the release's
        best_cfg, _ = card_config(best)
        require(best_cfg.conv_int8_qat, f"best.npz card: {best_cfg}")
        dropped = serving_overrides(best)
        sets = [*SERVING_MODE, *dropped,
                f"model.conv_int8_static={best_scales}"]
        scfg = apply_model_overrides(best_cfg, sets)
        check_sidecar(scfg, best)
        try:
            check_sidecar(dataclasses.replace(
                scfg, conv_int8_static=RELEASE_SCALES), best)
            refused = None
        except ValueError as e:
            refused = str(e)
        require(refused is not None and not any(
            "conv_int8_static" in s for s in dropped),
            f"sidecar check: the release's {refused} / {dropped}")
        best_params, _, _ = load_weights(best)
        model = build_model(scfg, "cuda").load_params(best_params)
        qat = sum(isinstance(m, QATConv) for m in model.module.modules())
        require(not model.cfg.conv_int8_qat and qat == 0,
                f"best.npz serves {qat} QAT convs")
        x = torch.from_numpy(np.random.default_rng(0).uniform(
            0, 1, CLIP).astype(np.float32)).cuda()
        launch_counts(reset=True)
        video, _ = model.infer_clip(x)
        torch.cuda.synchronize()
        launches = launch_counts()
        windows = CLIP[1] - scfg.window_size + 1
        want = scaled(per_window_launches(scfg, True), windows, s2d_pack=1)
        finite = bool(torch.isfinite(video).all())
        require(finite and launches == want, f"best.npz serving: finite "
                f"{finite}, launches {launches}, want {want}")
        info["serve_best"] = {"calibrate": rec, "overrides": sets,
                              "release_sidecar_refused": refused,
                              "shape": list(video.shape), "finite": finite,
                              "launches": launches}
        del model, video
    finally:
        shutil.rmtree(wd, ignore_errors=True)
    return info


# Phase folder: a user's own footage through python -m bin_tpu_torch.cli at
# config4_gopro_720p's full width.  (a) a sharp 240 fps .npy tree at 720p,
# FOLDER_CLIPS clips of FOLDER_FRAMES frames (8 blurry keys and 15 sharp
# frames each after prep); (b) train from the release weights on it with
# the worker loader, a checkpoint and an eval every 5 steps, and a copy of
# the workdir resumed from step 5: its batches and losses against the
# uninterrupted run's (below); (c) ms per step
# through train on config3_prf's synthetic stream, thread loader against
# workers; (d) export the EMA, evaluate the whole clips at 720x1280 from
# the checkpoint and from the .npz; (e) log.debug_nans on a NaN batch; (f)
# the demo on one clip's blurry folder.
FOLDER_CLIPS, FOLDER_FRAMES, FOLDER_HW = 3, 67, (720, 1280)
# The resumed run against the uninterrupted one: the same batches (by
# digest) and, with cuDNN deterministic, the first resumed step's loss bit
# for bit (the restored state and batch are the same, and the forward has
# no atomics); the later steps' losses drift, since the backward of the
# replicate pad and of the bilinear upsample accumulate with atomics in no
# fixed order.  Measured on an H100 80GB HBM3 at 700 W: 2.4e-5 relative at
# the second resumed step, growing to 1.14e-4 at the tenth; the bound is
# 1e-3 (a batch of another step reads 10-50 % off).
FOLDER_RESUME_LOSS_RTOL = 1e-3
FOLDER_KEYS = (FOLDER_FRAMES - 11) // 8 + 1
FOLDER_STEPS, FOLDER_RESUME_AT = 10, 5
FOLDER_SETS = ["data.num_workers=4", "optim.ema_decay=0.999",
               f"checkpoint.save_interval_steps={FOLDER_RESUME_AT}",
               f"log.eval_interval_steps={FOLDER_RESUME_AT}",
               f"log.log_interval_steps={FOLDER_RESUME_AT}",
               f"data.eval_num_keys={FOLDER_KEYS}"]
LOADER_STEPS, LOADER_FIRST_TIMED = 10, 4   # (c): steps 5-10 timed


def _set_args(sets: list[str]) -> list[str]:
    return [a for s in sets for a in ("--set", s)]


def render_tree(root: str) -> float:
    """FOLDER_CLIPS sharp 240 fps clips as uint8 .npy frames under
    root/<clip>/, rendered in threads; returns the seconds."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    from bin_tpu_torch.data.synthetic import render_sharp_clip

    def one(c: int) -> None:
        d = os.path.join(root, f"clip{c}")
        os.makedirs(d)
        clip = render_sharp_clip(100 + c, FOLDER_FRAMES, *FOLDER_HW,
                                 style="textured")
        for i, frame in enumerate(clip):
            np.save(os.path.join(d, f"{i:06d}.npy"),
                    (frame * 255.0 + 0.5).astype(np.uint8))

    t0 = time.perf_counter()
    with ThreadPoolExecutor(FOLDER_CLIPS) as ex:
        list(ex.map(one, range(FOLDER_CLIPS)))
    return time.perf_counter() - t0


def batch_digest(batch: dict) -> str:
    import hashlib

    h = hashlib.sha256()
    for k in sorted(batch):
        h.update(k.encode())
        h.update(batch[k].tobytes())
    return h.hexdigest()


@contextlib.contextmanager
def loader_digests(record: list):
    """Each batch's digest as the worker loader hands it out."""
    from unittest import mock

    from bin_tpu_torch.data.loader import WorkerLoader

    real = WorkerLoader.__next__

    def nxt(self):
        batch = real(self)
        record.append(batch_digest(batch))
        return batch

    with mock.patch.object(WorkerLoader, "__next__", nxt):
        yield


def cli_json(argv: list[str]) -> dict:
    """``python -m bin_tpu_torch.cli`` in this process: its last stdout
    line as JSON, the rest of its output kept off this script's."""
    import io

    from bin_tpu_torch import cli

    out = io.StringIO()
    with contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(io.StringIO()):
        cli.main(argv)
    return json.loads(out.getvalue().strip().splitlines()[-1])


def cli_train(torch, argv: list[str], record: list, digests: list):
    """``cli train`` with each step timed and counted (``timed_steps``) and
    each batch's digest kept; returns its JSON line and the run's
    launches."""
    from unittest import mock

    from bin_tpu_torch.training import trainer

    launch_counts(reset=True)
    with mock.patch.object(trainer, "make_train_step",
                           timed_steps(torch, trainer.make_train_step,
                                       record)), loader_digests(digests):
        rec = cli_json(["train", *argv])
    torch.cuda.synchronize()
    return rec, launch_counts()


def busy_ms_per_step(torch, cfg, params, steps: int = 5) -> float:
    """Device busy time of one train step (the sum of its kernels, from
    torch.profiler) on a fixed batch, after two warm-up steps."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from bin_tpu_torch import build_model
    from bin_tpu_torch.training import trainer
    from bin_tpu_torch.training.state import create_train_state, warm_start

    model = build_model(cfg.model, "cuda")
    state = warm_start(create_train_state(cfg, model), params)
    step = trainer.make_train_step(model, cfg)
    rng = np.random.default_rng(0)
    b, k, (h, w) = cfg.data.batch_size, cfg.data.seq_len, cfg.data.crop_size
    batch = {"blurry": torch.from_numpy(rng.integers(
        0, 256, (b, k, h, w, 3), np.uint8)).cuda(),
        "sharp": torch.from_numpy(rng.integers(
            0, 256, (b, 2 * k - 1, h, w, 3), np.uint8)).cuda()}
    for _ in range(2):
        state, _ = step(state, batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            state, _ = step(state, batch)
        torch.cuda.synchronize()
    us = 0.0
    for evt in prof.key_averages():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            t = getattr(evt, "self_device_time_total", None)
            us += evt.self_cuda_time_total if t is None else t
    return us / 1e3 / steps


def loader_step_times(torch, params, top: str) -> dict:
    """(c) config3_prf through train() on the synthetic stream: the thread
    loader against data.num_workers=4, ms per step by CUDA events over
    steps 5-10 (the span from step 5's start to step 10's end), and the
    device's idle share against the busy time of a fixed-batch step."""
    import shutil
    import tempfile
    from unittest import mock

    from bin_tpu_torch.config import get_config
    from bin_tpu_torch.training import trainer

    out = {}
    for name, sets in (("thread", []), ("workers_4", ["data.num_workers=4"])):
        cfg = get_config("config3_prf", [*TRAIN_SETS, *sets])
        wd = tempfile.mkdtemp(prefix="loader_", dir=top)
        record: list = []
        try:
            t0 = time.perf_counter()
            with mock.patch.object(trainer, "make_train_step",
                                   timed_steps(torch, trainer.make_train_step,
                                               record)):
                trainer.train(cfg, wd, LOADER_STEPS, WEIGHTS, "cuda")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            shutil.rmtree(wd, ignore_errors=True)
        s = step_summary(torch, record, cfg, first=LOADER_FIRST_TIMED)
        out[name] = {"ms_per_step": s["span_ms"] / (LOADER_STEPS
                                                    - LOADER_FIRST_TIMED),
                     "start_to_start_ms_median":
                         s["start_to_start_ms_median"],
                     "steps_timed": s["steps_timed"],
                     "step_enqueue_ms_median": s["ms_per_step_median"],
                     "wall_s": wall}
    busy = busy_ms_per_step(torch, get_config("config3_prf", TRAIN_SETS),
                            params)
    for v in out.values():
        v["device_busy_ms_per_step"] = busy
        v["device_idle_share"] = 1 - busy / v["ms_per_step"]
    out["speedup_workers_over_thread"] = (out["thread"]["ms_per_step"]
                                          / out["workers_4"]["ms_per_step"])
    return out


def phase_folder(torch, params, card: str, pil: bool, top: str) -> dict:
    import shutil
    import subprocess
    import tempfile

    import numpy as np

    from bin_tpu_torch import build_model
    from bin_tpu_torch.config import get_config
    from bin_tpu_torch.data.frames import load_frame
    from bin_tpu_torch.training import trainer
    from bin_tpu_torch.training.state import create_train_state, warm_start
    from bin_tpu_torch.weights import load_weights

    info: dict = {"card": card}
    if not pil:
        info["demo"] = "not run: no PIL"
    try:
        # (a) the data
        raw, tree = os.path.join(top, "raw240"), os.path.join(top, "tree")
        render_s = render_tree(raw)
        t0 = time.perf_counter()
        subprocess.run([sys.executable, "-m", "bin_tpu_torch.cli", "prep",
                        raw, tree], check=True, capture_output=True,
                       timeout=300, cwd=os.path.dirname(
                           os.path.abspath(__file__)))
        prep_s = time.perf_counter() - t0
        counts = {c: (len(os.listdir(os.path.join(tree, "blurry", c))),
                      len(os.listdir(os.path.join(tree, "sharp", c))))
                  for c in sorted(os.listdir(os.path.join(tree, "blurry")))}
        require(counts == {f"clip{c}": (FOLDER_KEYS, 2 * FOLDER_KEYS - 1)
                           for c in range(FOLDER_CLIPS)},
                f"prep wrote {counts}")
        key = 3
        taps = np.stack([load_frame(os.path.join(raw, "clip1",
                                                  f"{i:06d}.npy"))
                         for i in range(8 * key, 8 * key + 11)])
        want = (taps.mean(axis=0) * 255.0 + 0.5).astype(np.uint8)
        got = np.load(os.path.join(tree, "blurry", "clip1",
                                   f"{key:06d}.npy"))
        require(np.array_equal(got, want), "a blurry key is not the mean "
                "of its 11 taps")
        shutil.rmtree(raw)
        info["data"] = {"clips": FOLDER_CLIPS, "frames_240fps": FOLDER_FRAMES,
                        "size": list(FOLDER_HW), "keys_and_sharp": counts,
                        "render_s": render_s, "prep_s": prep_s}

        # (b) training on the tree with the worker loader, then resumed
        wd = os.path.join(top, "run")
        sets = [f"data.root={tree}", *FOLDER_SETS]
        argv = ["--preset", "config4_gopro_720p", *_set_args(sets),
                "--init-from", WEIGHTS, "--workdir", wd]
        cfg = get_config("config4_gopro_720p", sets)
        want = per_step_launches(cfg)
        require(want == {"lstm_gates": 9, "lstm_gates_bwd": 6, "s2d_pack": 2,
                         "quantize_act": 0, "int8_conv": 0},
                f"config4's step launches {want}")
        torch.backends.cudnn.deterministic = True
        record: list = []
        digests: list = []
        t0 = time.perf_counter()
        rec, launches = cli_train(torch, [*argv, "--steps",
                                          str(FOLDER_STEPS)], record, digests)
        wall = time.perf_counter() - t0
        for i, r in enumerate(record):
            require(r["launches"] == want,
                    f"folder step {i + 1} launches {r['launches']}")
        windows = FOLDER_KEYS - cfg.model.window_size + 1
        n_evals = FOLDER_STEPS // cfg.log.eval_interval_steps
        eval_want = scaled(per_window_launches(cfg.model, False),
                           windows * FOLDER_CLIPS * n_evals,
                           s2d_pack=FOLDER_CLIPS * n_evals)
        require(launches == {k: FOLDER_STEPS * want[k] + eval_want[k]
                             for k in want},
                f"folder run launches {launches}: {FOLDER_STEPS} x {want} "
                f"+ evals {eval_want}")
        losses = [r["loss"].item() for r in record]
        require(all(math.isfinite(v) for v in losses)
                and rec["skipped_steps"] == 0 and rec["step"] == FOLDER_STEPS,
                f"folder run {rec}, losses {losses}")
        loader_dir = os.path.join(wd, "checkpoints_loader")
        with open(os.path.join(loader_dir, f"{FOLDER_RESUME_AT}.bin")) as f:
            state_at_resume = json.load(f)
        require(state_at_resume["next_batch"] == FOLDER_RESUME_AT and sorted(
            os.listdir(loader_dir)) == sorted([f"{FOLDER_RESUME_AT}.bin",
                                               f"{FOLDER_STEPS}.bin"]),
            f"loader state {state_at_resume}, {os.listdir(loader_dir)}")
        with open(os.path.join(wd, cfg.log.jsonl_path)) as f:
            evals_logged = [r["eval_psnr_overall"] for r in map(json.loads, f)
                            if "eval_psnr_overall" in r]
        require(len(evals_logged) == n_evals and os.path.exists(
            os.path.join(wd, "best.npz")), f"in-training evals {evals_logged}")

        wd2 = os.path.join(top, "resumed")
        for sub, name in (("checkpoints", f"{FOLDER_RESUME_AT}.pt"),
                          ("checkpoints_loader", f"{FOLDER_RESUME_AT}.bin")):
            os.makedirs(os.path.join(wd2, sub))
            shutil.copy(os.path.join(wd, sub, name),
                        os.path.join(wd2, sub, name))
        record2: list = []
        digests2: list = []
        rec2, _ = cli_train(torch, [*argv[:-1], wd2, "--steps",
                                    str(FOLDER_STEPS)], record2, digests2)
        torch.backends.cudnn.deterministic = False
        n = FOLDER_STEPS - FOLDER_RESUME_AT
        require(rec2["step"] == FOLDER_STEPS and len(record2) == n,
                f"resumed run {rec2}")
        same_batches = digests2[:n] == digests[FOLDER_RESUME_AT:FOLDER_STEPS]
        losses2 = [r["loss"].item() for r in record2]
        require(same_batches, "resumed batches differ from the "
                "uninterrupted run's")
        drift = [abs(a / b - 1) for a, b in zip(losses2,
                                                losses[FOLDER_RESUME_AT:])]
        require(losses2[0] == losses[FOLDER_RESUME_AT]
                and max(drift) <= FOLDER_RESUME_LOSS_RTOL,
                f"resumed losses {losses2} vs {losses[FOLDER_RESUME_AT:]}")
        info["train"] = {
            "argv": ["train", *argv, "--steps", str(FOLDER_STEPS)],
            **step_summary(torch, record, cfg), "wall_s": wall,
            "losses": losses, "launches": launches,
            "launches_per_step": want, "launches_of_evals": eval_want,
            "host_syncs_in_step": [r["syncs"] for r in record],
            "eval_psnr_overall": evals_logged, "loader_state_at_resume": state_at_resume,
            "cudnn_deterministic": True}
        info["resume"] = {"from_step": FOLDER_RESUME_AT, "steps": n,
                          "batches_equal": same_batches,
                          "first_loss_equal": True,
                          "loss_rel_drift": drift,
                          "loss_rel_bound": FOLDER_RESUME_LOSS_RTOL,
                          "losses": losses2}
        del record, record2

        # (c) ms per step through train: thread loader against workers
        info["loader_step_time"] = loader_step_times(torch, params, top)

        # (d) export the EMA; whole-clip eval from the checkpoint and the .npz
        npz = os.path.join(top, "exported.npz")
        cli_json(["export", "--preset", "config4_gopro_720p",
                  *_set_args(sets), "--checkpoint",
                  os.path.join(wd, "checkpoints"), "--ema", "--out", npz])
        whole = ["--preset", "config4_gopro_720p",
                 *_set_args([f"data.root={tree}", "data.eval_num_keys=0"]),
                 "--device", "cuda"]
        torch.backends.cudnn.deterministic = True
        evals = {}
        for name, ck in (("checkpoint", ["--checkpoint",
                                         os.path.join(wd, "checkpoints"),
                                         "--ema"]),
                         ("exported_npz", ["--checkpoint", npz])):
            launch_counts(reset=True)
            evals[name] = cli_json(["eval", *whole, *ck])
            torch.cuda.synchronize()
            evals[name + "_launches"] = launch_counts()
        torch.backends.cudnn.deterministic = False
        per_clip = scaled(per_window_launches(cfg.model, False), windows,
                          s2d_pack=1)
        require(evals["checkpoint"] == evals["exported_npz"],
                f"whole-clip evals differ: {evals}")
        for name in ("checkpoint", "exported_npz"):
            got = evals[name + "_launches"]
            require(got == scaled(per_clip, FOLDER_CLIPS),
                    f"eval launches {got}, want {FOLDER_CLIPS} x {per_clip}")
            require(all(math.isfinite(v) for v in evals[name].values()),
                    f"eval {evals[name]}")
        exp_params, exp_cfg, _ = load_weights(npz)
        model = build_model(exp_cfg, "cuda").load_params(exp_params)
        clip_dir = os.path.join(tree, "blurry", "clip0")
        blurry = np.stack([load_frame(os.path.join(clip_dir, f))
                           for f in sorted(os.listdir(clip_dir))])[None]
        launch_counts(reset=True)
        video, times = model.infer_clip(torch.from_numpy(blurry).cuda())
        torch.cuda.synchronize()
        clip_launches = launch_counts()
        finite = bool(torch.isfinite(video).all())
        require(finite and clip_launches == per_clip
                and tuple(video.shape[2:4]) == FOLDER_HW,
                f"whole clip: finite {finite}, launches {clip_launches}, "
                f"shape {tuple(video.shape)}")
        info["whole_clip_eval"] = {
            "size": list(FOLDER_HW), "clips": FOLDER_CLIPS,
            "keys_per_clip": FOLDER_KEYS, **evals,
            "launches_per_clip": per_clip, "equal": True,
            "frames": {"shape": list(video.shape), "finite": finite}}

        # (e) log.debug_nans: one clean step, then a NaN batch
        dcfg = get_config("config4_gopro_720p", [*sets, "log.debug_nans=true"])
        dmodel = build_model(dcfg.model, "cuda")
        dstate = warm_start(create_train_state(dcfg, dmodel), params)
        rng = np.random.default_rng(5)
        b, k, (ch, cw) = (dcfg.data.batch_size, dcfg.data.seq_len,
                          dcfg.data.crop_size)
        batch = {"blurry": rng.uniform(0, 1, (b, k, ch, cw, 3)),
                 "sharp": rng.uniform(0, 1, (b, 2 * k - 1, ch, cw, 3))}
        batch = {n_: torch.from_numpy(v.astype(np.float32)).cuda()
                 for n_, v in batch.items()}
        step = trainer.make_train_step(dmodel, dcfg)
        dstate, _ = step(dstate, batch)
        batch["blurry"][0, 1, 5, 7, 2] = float("nan")
        before = dstate.params.clone()
        try:
            step(dstate, batch)
            raised = None
        except FloatingPointError as e:
            raised = str(e)
        require(raised is not None and "step 2" in raised
                and dstate.step == 1 and torch.equal(dstate.params, before),
                f"debug_nans: raised {raised}, step {dstate.step}")
        info["debug_nans"] = {"raised": raised, "state_kept": True}
        del dmodel, dstate, before

        # (f) the demo on clip0's blurry .npy folder
        if pil:
            from PIL import Image

            out_dir = os.path.join(top, "demo")
            demo_line = cli_demo(["demo", "--weights", npz, "--input",
                                  clip_dir, "--out", out_dir])
            pngs = sorted(os.listdir(os.path.join(out_dir, "demo")))
            require(len(pngs) == video.shape[1],
                    f"demo wrote {len(pngs)} frames, want {video.shape[1]}")
            first = np.asarray(Image.open(os.path.join(out_dir, "demo",
                                                       pngs[0])))
            ref = (video[0, 0].clamp(0, 1) * 255.0 + 0.5).to(
                torch.uint8).cpu().numpy()
            require(first.shape == (*FOLDER_HW, 3)
                    and int(np.abs(first.astype(int) - ref).max()) <= 1,
                    "demo frame differs from infer_clip's")
            info["demo"] = {"frames": len(pngs), "times": [int(t) for t in
                                                           times],
                            "output": demo_line}
        del model, video
    finally:
        torch.backends.cudnn.deterministic = False
    return info


def config5_serving_model(torch):
    """``bench_torch.py --stem 4 --base 256``'s model on the card:
    config5_v5e_streaming in the serving mode, ``Model.init(0)``, the
    release's static scales (as ``bench.py`` keeps them there)."""
    from bin_tpu_torch import benchmark

    args = benchmark.parse_args(["--stem", "4", "--base", "256"])
    model, cfg, *_ = benchmark.bench_model(args, torch.device("cuda"))
    return model, cfg


def phase_config5_int8(torch) -> tuple[dict, dict]:
    """K3q and K3 at every shape of config5's serving path at 720p: the
    calls of one window of ``config5_serving_model`` recorded with their
    inputs, each distinct one held bit for bit against its plain version
    (K3 twice, on output memory poisoned with NaN), timed, and summed over
    a clip's windows beside its bound, its plain version, the im2col +
    ``torch._int_mm`` route and cuDNN's bf16 conv of the shape."""
    from unittest import mock

    import numpy as np
    import torch.nn.functional as F

    from bin_tpu_torch.ops import quant

    model, cfg = config5_serving_model(torch)
    k3_calls: dict = {}
    q_calls: dict = {}
    real_k3, real_q = quant.int8_conv3x3, quant.quantize_act

    def keep(v):
        return v.clone() if torch.is_tensor(v) else v

    def rec_k3(*args, **kw):
        a = inspect.signature(real_k3).bind(*args, **kw)
        a.apply_defaults()
        a = a.arguments
        key = (tuple(a["xq"].shape), a["qweight"].shape[0], a["stride"],
               tuple(a["pad"]), str(a["out_dtype"]), a["bias"] is not None,
               a["addend"] is not None, a["slope"],
               a["residual"] is not None)
        if key not in k3_calls:
            k3_calls[key] = [{k: keep(v) for k, v in a.items()}, 0]
        k3_calls[key][1] += 1
        return real_k3(*args, **kw)

    def rec_q(x, scale):
        key = (tuple(x.shape), str(x.dtype))
        if key not in q_calls:
            q_calls[key] = [x.clone(), keep(scale), 0]
        q_calls[key][2] += 1
        return real_q(x, scale)

    window = torch.from_numpy(np.random.default_rng(0).uniform(
        0, 1, (1, cfg.window_size, *CLIP[2:])).astype(np.float32)).cuda()
    with mock.patch.object(quant, "int8_conv3x3", rec_k3), \
            mock.patch.object(quant, "quantize_act", rec_q):
        model.infer_clip(window)
    torch.cuda.synchronize()
    del model, window
    windows = CLIP[1] - cfg.window_size + 1
    k3_rows, q_rows = [], []
    per_clip = {k: 0.0 for k in ("ms", "plain_ms", "bound_ms",
                                 "im2col_int_mm_ms", "cudnn_bf16_ms",
                                 "quantize_ms", "quantize_plain_ms",
                                 "quantize_bound_ms")}
    per_clip["launches"] = windows * sum(c[1] for c in k3_calls.values())
    for key, (kw, count) in k3_calls.items():
        ref = quant.int8_conv3x3_ref(**kw)
        for _ in range(2):
            torch.full_like(ref, float("nan"))  # freed: the next output's
            out = real_k3(**kw)
            torch.cuda.synchronize()
            require(out.shape == ref.shape and torch.equal(out, ref),
                    f"K3 config5 {key}: not bit-exact")
        xq, qw, ks, bias, addend = (kw[k] for k in (
            "xq", "qweight", "kscale", "bias", "addend"))
        stride, pad = kw["stride"], kw["pad"]
        n, h, w, cin = xq.shape
        cout = qw.shape[0]
        ops = 2 * n * out.shape[1] * out.shape[2] * cout * 9 * cin
        nbytes = (xq.nbytes + qw.nbytes + ks.nbytes + 4
                  + out.nbytes * (2 if key[-1] else 1)
                  + (bias.nbytes if bias is not None else 0)
                  + (addend.nbytes if addend is not None else 0))
        b_ms, b_by = bound_ms(nbytes, ops, INT8_OPS_PER_S)
        xc = xq.to(torch.bfloat16).permute(0, 3, 1, 2)
        wc = qw.to(torch.bfloat16).permute(0, 3, 1, 2)
        row = {"x": list(xq.shape), "cout": cout, "stride": stride,
               "out": key[4], "bias": key[5], "addend": key[6],
               "slope": key[7], "residual": key[8],
               "launches_per_clip": windows * count, "bit_exact": True,
               "ops": ops, "bytes": nbytes, "bound_ms": b_ms,
               "bound_by": b_by,
               "ms": device_ms(torch, lambda: real_k3(**kw), 10),
               "plain_ms": device_ms(
                   torch, lambda: quant.int8_conv3x3_ref(**kw), 3),
               "im2col_int_mm_ms": device_ms(
                   torch, lambda: quant.int8_conv_ref(xq, qw, stride, pad),
                   3),
               "cudnn_bf16_ms": device_ms(torch, lambda: F.conv2d(
                   xc, wc, None, stride, 1), 5)}
        row["share_of_bound"] = b_ms / row["ms"]
        for k in ("ms", "plain_ms", "bound_ms", "im2col_int_mm_ms",
                  "cudnn_bf16_ms"):
            per_clip[k] += windows * count * row[k]
        k3_rows.append(row)
        del ref, out, xc, wc
    for (shape, dt), (x, scale, count) in q_calls.items():
        require(torch.equal(real_q(x, scale),
                            quant.quantize_act_ref(x, scale)),
                f"K3q config5 {shape} {dt}: not bit-exact")
        b_ms = bound_ms(x.nbytes + x.numel(), 0)[0]
        row = {"x": list(shape), "dtype": dt, "bit_exact": True,
               "launches_per_clip": windows * count, "bound_ms": b_ms,
               "ms": device_ms(torch, lambda: real_q(x, scale), 10),
               "plain_ms": device_ms(
                   torch, lambda: quant.quantize_act_ref(x, scale), 3)}
        row["share_of_bound"] = b_ms / row["ms"]
        per_clip["quantize_ms"] += windows * count * row["ms"]
        per_clip["quantize_plain_ms"] += windows * count * row["plain_ms"]
        per_clip["quantize_bound_ms"] += windows * count * b_ms
        q_rows.append(row)
    per_clip["share_of_bound"] = per_clip["bound_ms"] / per_clip["ms"]
    per_clip["quantize_share_of_bound"] = (per_clip["quantize_bound_ms"]
                                           / per_clip["quantize_ms"])
    per_clip["quantize_launches"] = windows * sum(
        c[2] for c in q_calls.values())
    del k3_calls, q_calls
    torch.cuda.empty_cache()
    return {"k3": k3_rows, "k3q": q_rows}, per_clip


# Phase perceptual: the extended config's VGG term from the release
# weights, config3_prf's recipe otherwise (EMA 0.999), 4 loader workers.
# The VGG loss alone, card against CPU in fp32 with TF32 off, is held to
# phase train's bounds: the loss within TRAIN_LOSS_RTOL, its gradient with
# respect to the prediction within TRAIN_SWITCH_REL_L2, the bound of the
# gradients that a kink's side switch moves.  The VGG's ReLUs and 2x2
# max-pools are such kinks: where the two devices' sums round a ReLU input
# across 0, or reorder two pooled values within rounding, the gradient
# goes to another side or pixel.  Measured on an H100 80GB HBM3 at 700 W:
# 1.64e-3 card against CPU; the CPU against itself under a 1 + 1e-7 scale
# of the prediction is recorded beside it.
VGG_STEPS = 20
VGG_SETS = ["loss.perceptual_mode=vgg", "data.num_workers=4",
            "log.log_interval_steps=10", "checkpoint.save_interval_steps=1000"]
VGG_CPU_SHAPE = (1, 3, TRAIN_CROP, TRAIN_CROP, 3)


def vgg_card_vs_cpu(torch, tmp: str) -> dict:
    """The VGG loss (seed-0 fallback filters to relu3_3) and its gradient
    with respect to ``pred``, card against CPU, fp32 with TF32 off; and a
    ``.pth`` written from the fallback through ``loss.vgg_weights``, which
    must give the fallback's loss on the card bit for bit."""
    import numpy as np

    from bin_tpu_torch.config import LossConfig
    from bin_tpu_torch.losses import build_perceptual_fn
    from bin_tpu_torch.perceptual import VGG16_CHANNELS, init_vgg16_params

    rng = np.random.default_rng(21)
    pred, target = (torch.from_numpy(rng.uniform(0, 1, VGG_CPU_SHAPE).astype(
        np.float32)) for _ in range(2))
    cfg = LossConfig(perceptual_weight=0.5, perceptual_mode="vgg")
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        runs = {}
        for dev in ("cpu", "cuda"):
            fn = build_perceptual_fn(cfg, dev)
            p = pred.to(dev, copy=True).requires_grad_()
            with torch.enable_grad():
                loss = fn(p, target.to(dev))
                loss.backward()
            runs[dev] = (loss.item(), p.grad.cpu())
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = flags
    loss_rel = abs(runs["cuda"][0] / runs["cpu"][0] - 1)
    grad_rel = rel_l2(runs["cuda"][1], runs["cpu"][1])
    require(loss_rel <= TRAIN_LOSS_RTOL and grad_rel <= TRAIN_SWITCH_REL_L2,
            f"VGG loss card vs CPU: loss {loss_rel}, gradient {grad_rel}")
    fn = build_perceptual_fn(cfg, "cpu")
    p = (pred * (1 + 1e-7)).requires_grad_()
    with torch.enable_grad():
        fn(p, target).backward()
    cpu_self = rel_l2(p.grad, runs["cpu"][1])
    # the fallback as a torchvision checkpoint, loaded by loss.vgg_weights
    params, sd, idx = init_vgg16_params(0), {}, 0
    for c in VGG16_CHANNELS:
        if c == "M":
            idx += 1
            continue
        k, b = params[len(sd) // 2]
        sd[f"features.{idx}.weight"] = torch.from_numpy(
            np.ascontiguousarray(k.transpose(3, 2, 0, 1)))
        sd[f"features.{idx}.bias"] = torch.from_numpy(b)
        idx += 2
    pth = os.path.join(tmp, "vgg16_fallback.pth")
    torch.save(sd, pth)
    with torch.no_grad():
        a = build_perceptual_fn(cfg, "cuda")(pred.cuda(), target.cuda())
        b = build_perceptual_fn(LossConfig(
            perceptual_weight=0.5, perceptual_mode="vgg", vgg_weights=pth),
            "cuda")(pred.cuda(), target.cuda())
    require(torch.equal(a, b), f"loss.vgg_weights {b.item()} vs the "
            f"fallback {a.item()}")
    return {"shape": list(VGG_CPU_SHAPE), "loss_cpu": runs["cpu"][0],
            "loss_card": runs["cuda"][0], "loss_rel_diff": loss_rel,
            "grad_rel_l2": grad_rel, "loss_bound": TRAIN_LOSS_RTOL,
            "grad_bound": TRAIN_SWITCH_REL_L2,
            "cpu_grad_move_under_1e-7_scale": cpu_self, "tf32": False,
            "pth_equals_fallback": True, "pth_loss": b.item()}


def phase_perceptual(torch, params, card: str) -> dict:
    import shutil
    import tempfile

    from bin_tpu_torch.config import get_config

    tmp = tempfile.mkdtemp(prefix="smoke_vgg_")
    try:
        info = {"card": card, "card_vs_cpu": vgg_card_vs_cpu(torch, tmp)}
        argv = ["--preset", "config3_prf_extended", *_set_args(VGG_SETS),
                "--init-from", WEIGHTS, "--workdir",
                os.path.join(tmp, "run"), "--steps", str(VGG_STEPS)]
        cfg = get_config("config3_prf_extended", VGG_SETS)
        want = per_step_launches(cfg)
        record: list = []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        rec, launches = cli_train(torch, argv, record, [])
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        for i, r in enumerate(record):
            require(r["launches"] == want,
                    f"VGG step {i + 1} launches {r['launches']}")
        losses = [r["loss"].item() for r in record]
        require(all(math.isfinite(v) for v in losses)
                and rec["skipped_steps"] == 0 and rec["step"] == VGG_STEPS,
                f"VGG run {rec}, losses {losses}")
        with open(os.path.join(tmp, "run", cfg.log.jsonl_path)) as f:
            logged = [json.loads(line) for line in f]
        require(all(r["loss_perceptual"] > 0 for r in logged),
                f"the VGG term did not run: {logged}")
        summary = step_summary(torch, record, cfg)
        busy = busy_ms_per_step(torch, cfg, params, steps=3)
        per_step = summary["span_ms"] / (VGG_STEPS - 4)
        info["train"] = {
            "argv": ["train", *argv], **summary, "wall_s": wall,
            "ms_per_step_start_to_start": per_step,
            "device_busy_ms_per_step": busy,
            "device_idle_share": 1 - busy / per_step,
            "peak_memory_bytes": peak, "losses": losses,
            "loss_perceptual_logged": [r["loss_perceptual"] for r in logged],
            "launches": launches, "launches_per_step": want,
            "host_syncs_in_step": [r["syncs"] for r in record]}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    require(not os.path.exists(tmp), f"{tmp} left behind")
    return info


def phase_import_torch(torch, params, cfg, card: str) -> dict:
    """The release weights as a PyTorch checkpoint (``to_torch_state_dict``,
    ``module.``-prefixed, under ``state_dict``) in a temporary directory
    outside the repo, back through ``cli import-torch``: every array and
    the card's config equal to the release's, and ``infer_clip`` of a 720p
    clip in bf16 from the imported ``.npz`` equal to the original's bit for
    bit."""
    import dataclasses
    import io
    import shutil
    import tempfile

    import numpy as np

    from bin_tpu_torch import build_model, cli
    from bin_tpu_torch.import_torch import to_torch_state_dict
    from bin_tpu_torch.weights import flatten, load_weights

    tmp = tempfile.mkdtemp(prefix="smoke_import_")
    try:
        pth, npz = os.path.join(tmp, "ref.pth"), os.path.join(tmp, "imp.npz")
        torch.save({"state_dict": {
            f"module.{k}": torch.from_numpy(np.ascontiguousarray(v))
            for k, v in to_torch_state_dict(params).items()}, "epoch": 0},
            pth)
        t0 = time.perf_counter()
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            cli.main(["import-torch", "--preset", "config3_prf",
                      "--torch-checkpoint", pth, "--out", npz])
        import_s = time.perf_counter() - t0
        got, got_cfg, meta = load_weights(npz)
        ours, want = flatten(got), flatten(params)
        require(sorted(ours) == sorted(want) and all(
            ours[k].dtype == want[k].dtype and np.array_equal(ours[k], want[k])
            for k in want), "imported arrays differ from the release's")
        require(got_cfg == cfg, f"imported card {got_cfg} vs {cfg}")
        clip = torch.from_numpy(np.random.default_rng(0).uniform(
            0, 1, CLIP).astype(np.float32)).cuda()
        videos = []
        for tree, mcfg in ((params, cfg), (got, got_cfg)):
            model = build_model(dataclasses.replace(mcfg, dtype="bfloat16"),
                                "cuda").load_params(tree)
            videos.append(model.infer_clip(clip)[0])
            del model
        require(torch.equal(*videos), "infer_clip of the imported weights "
                "differs from the release's")
        sizes = {"pth": os.path.getsize(pth), "npz": os.path.getsize(npz)}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    require(not os.path.exists(tmp), f"{tmp} left behind")
    return {"card": card, "arrays": len(want), "arrays_equal": True,
            "card_config_equal": True, "metadata": meta,
            "import_seconds": import_s, "bytes": sizes,
            "output": out.getvalue().strip(),
            "infer_clip_bit_exact": {"shape": list(CLIP), "dtype": "bf16",
                                     "video": list(videos[0].shape)},
            "temporary_files_removed": True}


# Phase parallel: config5_v5e_streaming (stem 4, base 256, bf16, batch 8,
# 6 keys, 128x128 crops, data_axis_size -1) at full width on phase folder's
# 720p tree, from random weights (Model.init(seed 0); no release exists at
# this width), 4 loader workers, 10 steps: in this process, then under
# torchrun (NCCL, one rank), cuDNN deterministic in both.  The losses are
# held within 1e-3 of each other (the backward of the replicate pad and of
# the bilinear upsample add with atomics, as phase folder found), and the
# whole-clip 720p evals of the checkpoint to the last bit.  From random
# weights at the preset's lr of 1e-4 the loss jumps from 0.096 to 13.6 at
# step 2 (Adam's first step moves every weight by the lr, the zero tail
# too), and from there two plain runs of the same config differ as much as
# the atomics let them grow: 4.0e-4 at step 3, 21 % at step 10 (measured
# on an H100 80GB HBM3 at 700 W).  So the steps warm the lr up over 1000
# steps, as a run from scratch does, which keeps the 10 steps out of that
# blow-up.
PAR_STEPS = 10
PAR_LOSS_RTOL = 1e-3
PAR_SETS = ["data.num_workers=4", "log.log_interval_steps=10",
            "checkpoint.save_interval_steps=10", "optim.lr_warmup_steps=1000"]
PAR_TIMEOUT_S = 300
STREAM_BATCH = 8


def run_torchrun(commands: list[list[str]], out_json: str) -> dict:
    """``python -m torch.distributed.run --standalone --nproc_per_node=1``
    of this script's rank mode on ``commands`` (``cli`` commands, run in
    turn by one launch), in its own process group, killed whole at the
    timeout; the rank's JSON record."""
    import signal

    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node=1", os.path.abspath(__file__), "--rank-cli",
           out_json, json.dumps(commands)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            cwd=os.path.dirname(os.path.abspath(__file__)),
                            start_new_session=True)
    try:
        _, err = proc.communicate(timeout=PAR_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise AssertionError(f"torchrun took over {PAR_TIMEOUT_S} s")
    require(proc.returncode == 0,
            f"torchrun: rc {proc.returncode}\n{err[-3000:]}")
    with open(out_json) as f:
        return json.load(f)


def rank_cli(out_json: str, commands: list[list[str]]) -> int:
    """The rank mode of this script under torchrun: join the NCCL group,
    run each ``cli`` command of ``commands`` with cuDNN deterministic
    (train: each step timed and counted), and have rank 0 write the
    records to ``out_json``.  The commands run in one process group,
    which it leaves at the end."""
    import io
    from unittest import mock

    import torch
    import torch.distributed as dist

    from bin_tpu_torch import cli
    from bin_tpu_torch.config import get_config
    from bin_tpu_torch.parallel import maybe_initialize
    from bin_tpu_torch.parallel.distributed import shutdown
    from bin_tpu_torch.training import trainer

    torch.backends.cudnn.deterministic = True
    require(maybe_initialize("cuda"), "not started by a launcher")
    group = {"backend": dist.get_backend(), "world": dist.get_world_size(),
             "rank": dist.get_rank(),
             "device": str(torch.cuda.current_device())}
    runs = []
    for argv in commands:
        record: list = []
        torch.cuda.reset_peak_memory_stats()
        launch_counts(reset=True)
        out = io.StringIO()
        with mock.patch.object(trainer, "make_train_step",
                               timed_steps(torch, trainer.make_train_step,
                                           record)), \
                contextlib.redirect_stdout(out):
            cli.COMMANDS[argv[0]](argv[1:])  # cli.main would leave the group
        result = json.loads(out.getvalue().strip().splitlines()[-1])
        torch.cuda.synchronize()
        run = {**group, "result": result, "launches": launch_counts(),
               "losses": [r["loss"].item() for r in record],
               "launches_per_step": [r["launches"] for r in record],
               "peak_memory_bytes": torch.cuda.max_memory_allocated()}
        if len(record) > 4:
            run["summary"] = step_summary(torch, record, get_config(
                "config5_v5e_streaming"))
        runs.append(run)
        del record
        torch.cuda.empty_cache()
    if group["rank"] == 0:
        with open(out_json, "w") as f:
            json.dump(runs, f)
    shutdown()
    return 0


def bench_records(torch) -> dict:
    """``bench_torch.py`` at (1, 8, 720, 1280): stem 4 / base 256 (random
    weights) in bf16 and the serving mode, and the streaming session of 8
    streams (``--streaming --batch 8``), each beside the release's stem 2
    by the same method, in this process; the launches of each."""
    from bin_tpu_torch import benchmark

    out = {}
    for name, argv in (
            ("stem2_serving", []),
            ("stem2_bf16", ["--set", "model.conv_int8=false"]),
            ("stem4_serving", ["--stem", "4", "--base", "256"]),
            ("stem4_bf16", ["--stem", "4", "--base", "256", "--set",
                            "model.conv_int8=false"]),
            ("stem2_streaming_b8", ["--streaming", "--batch",
                                    str(STREAM_BATCH)]),
            ("stem4_streaming_b8", ["--streaming", "--batch",
                                    str(STREAM_BATCH), "--stem", "4",
                                    "--base", "256"])):
        args = benchmark.parse_args(argv)
        launch_counts(reset=True)
        rec = benchmark.run(args)
        torch.cuda.synchronize()
        d = rec["detail"]
        runs = args.warmup + args.iters
        out[name] = {"argv": argv, "value": rec["value"], "unit": rec["unit"],
                     "mode": d["mode"], "model": d["model"],
                     "weights": d["weights"],
                     "peak_memory_bytes": d["peak_memory_bytes"],
                     "launches": launch_counts()}
        if args.streaming:
            out[name].update({k: d[k] for k in (
                "per_key_latency_ms", "frames_out", "seconds",
                "batch_streams", "drain_every")})
        else:
            out[name].update(median_ms=d["median_ms"],
                             spread_ms=d["spread_ms"], run_ms=d["run_ms"],
                             launches_per_clip={
                                 k: v / runs for k, v in
                                 out[name]["launches"].items()})
        torch.cuda.empty_cache()
    return out


def phase_parallel(torch, card: str, tree: str, top: str) -> dict:
    """config5 trained in this process, its checkpoint evaluated; then one
    ``torchrun`` launch that trains the same steps and evaluates the same
    checkpoint; then ``bench_records``."""
    from bin_tpu_torch.config import get_config

    preset = "config5_v5e_streaming"
    sets = [f"data.root={tree}", *PAR_SETS]
    cfg = get_config(preset, sets)
    want = per_step_launches(cfg)
    require(want == {"lstm_gates": 9, "lstm_gates_bwd": 6, "s2d_pack": 2,
                     "quantize_act": 0, "int8_conv": 0},
            f"config5's step launches {want}")
    windows = FOLDER_KEYS - cfg.model.window_size + 1
    per_clip = scaled(per_window_launches(cfg.model, False), windows,
                      s2d_pack=1)

    def train_argv(name: str) -> list[str]:
        return ["train", "--preset", preset, *_set_args(sets), "--workdir",
                os.path.join(top, f"config5_{name}"), "--steps",
                str(PAR_STEPS)]

    eval_argv = ["eval", "--preset", preset,
                 *_set_args([f"data.root={tree}", "data.eval_num_keys=0"]),
                 "--checkpoint", os.path.join(top, "config5_plain",
                                              "checkpoints")]
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    record: list = []
    torch.backends.cudnn.deterministic = True
    torch.cuda.reset_peak_memory_stats()
    try:
        rec, launches = cli_train(torch, train_argv("plain")[1:], record, [])
        peak = torch.cuda.max_memory_allocated()
        launch_counts(reset=True)
        plain_eval = cli_json(eval_argv)
        torch.cuda.synchronize()
        plain_eval_launches = launch_counts()
    finally:
        torch.backends.cudnn.deterministic = False
    plain = {"result": rec, "launches": launches,
             "losses": [r["loss"].item() for r in record],
             "launches_per_step": [r["launches"] for r in record],
             "peak_memory_bytes": peak,
             "summary": step_summary(torch, record, cfg),
             "wall_s": time.perf_counter() - t0}
    del record
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranked, ranked_eval = run_torchrun([train_argv("torchrun"), eval_argv],
                                       os.path.join(top, "rank.json"))
    ranked["wall_s"] = time.perf_counter() - t0
    require(ranked["backend"] == "nccl" and ranked["world"] == 1,
            f"torchrun group {ranked}")
    for name, run in (("plain", plain), ("torchrun", ranked)):
        require(run["result"]["step"] == PAR_STEPS
                and run["result"]["skipped_steps"] == 0
                and all(math.isfinite(v) for v in run["losses"]),
                f"config5 {name}: {run['result']}, losses {run['losses']}")
        require(all(s == want for s in run["launches_per_step"]),
                f"config5 {name} launches {run['launches_per_step']}")
    drift = [abs(a / b - 1) for a, b in zip(ranked["losses"],
                                            plain["losses"])]
    require(len(drift) == PAR_STEPS and max(drift) <= PAR_LOSS_RTOL,
            f"torchrun losses {ranked['losses']} vs {plain['losses']}")
    info = {"card": card, "preset": preset,
            "train": {"plain": plain, "torchrun": ranked,
                      "loss_rel_drift": drift,
                      "loss_rel_bound": PAR_LOSS_RTOL,
                      "launches_per_step": want, "cudnn_deterministic": True}}

    # the whole-clip 720p evals of the plain run's checkpoint
    require(plain_eval == ranked_eval["result"], f"config5 evals differ: "
            f"{plain_eval} vs {ranked_eval['result']}")
    for got in (plain_eval_launches, ranked_eval["launches"]):
        require(got == scaled(per_clip, FOLDER_CLIPS),
                f"config5 eval launches {got}, want {FOLDER_CLIPS} x "
                f"{per_clip}")
    require(all(math.isfinite(v) for v in plain_eval.values()),
            f"eval {plain_eval}")
    info["eval"] = {"size": list(FOLDER_HW), "clips": FOLDER_CLIPS,
                    "keys_per_clip": FOLDER_KEYS, "plain": plain_eval,
                    "torchrun": ranked_eval["result"], "equal": True,
                    "launches_per_clip": per_clip,
                    "torchrun_group": {k: ranked_eval[k] for k in (
                        "backend", "world", "rank", "device")}}
    info["bench"] = bench_records(torch)
    return info


def cli_demo(argv: list[str]) -> str:
    """``cli demo`` in this process; its last line."""
    import io

    from bin_tpu_torch import cli

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        cli.main(argv)
    return out.getvalue().strip().splitlines()[-1]


def main() -> int:
    if sys.argv[1:2] == ["--rank-cli"]:  # a rank under torchrun (parallel)
        return rank_cli(sys.argv[2], json.loads(sys.argv[3]))
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
        import importlib.util
        pil = importlib.util.find_spec("PIL") is not None
        info.update(nvidia_smi=smi, pil=pil, torch=torch.__version__,
                    cuda=torch.version.cuda,
                    device=torch.cuda.get_device_name(0),
                    count=torch.cuda.device_count(),
                    cudnn_allow_tf32=torch.backends.cudnn.allow_tf32,
                    matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32)

    import dataclasses

    from bin_tpu_torch import build_model
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
        int8_rows, info["int8_conv_per_clip"] = phase_int8_kernels(torch, cfg)
        table.update(int8_rows)
        c5_rows, c5_clip = phase_config5_int8(torch)
        info["config5_int8_per_clip"] = c5_clip
        table["int8_conv"]["config5_per_clip"] = c5_clip
        table["int8_conv"]["cases"] += c5_rows["k3"]
        table["quantize_act"]["cases"] += c5_rows["k3q"]
        info["kernels"] = [
            {"name": r["name"], "max_abs_diff": r["max_abs_err"],
             "kernel_ms": r["ms"], "plain_ms": r["plain_ms"],
             "bound_ms": r["bound_ms"], "library_ms": r["library_ms"],
             "share_of_bound": r["share_of_bound"],
             "cases": r.pop("cases")} for r in table.values()]

    with Phase("card_vs_cpu") as info:
        info.update(phase_card_vs_cpu(torch, params, cfg))

    with Phase("slice") as info:
        model = build_model(dataclasses.replace(cfg, dtype="bfloat16"),
                            "cuda").load_params(params)
        slice_info, bf16_video = drive(torch, model, {
            "lstm_gates": 15, "lstm_gates_bwd": 0, "s2d_pack": 1,
            "quantize_act": 0, "int8_conv": 0}, card)
        del model
        info.update(slice_info)
        for name in ("lstm_gates", "s2d_pack"):
            table[name]["launches"] = info["launches"][name]

    with Phase("serving") as info:
        serving_info, serving_model = phase_serving(torch, params, cfg, card,
                                                    bf16_video)
        info.update(serving_info)
        for name in ("quantize_act", "int8_conv"):
            table[name]["launches"] = info["launches"][name]
    del bf16_video

    bf16_model = build_model(dataclasses.replace(cfg, dtype="bfloat16"),
                             "cuda").load_params(params)
    with Phase("quality") as info:
        protocol, clips, info["render_seconds"] = protocol_clips(cfg)
        info.update(phase_quality(torch, cfg, bf16_model, serving_model,
                                  protocol, clips))

    with Phase("streaming") as info:
        info.update(phase_streaming(torch, serving_model, bf16_model))
        per_key = info["serving"]["launches_per_key"]
        for name, n in per_key.items():
            table[name]["launches_per_key"] = n
        table["s2d_pack"]["per_key_u8"]["launches_per_key"] = (
            per_key["s2d_pack"])

    with Phase("http") as info:
        info.update(phase_http(torch, serving_model))
    del serving_model, bf16_model

    with Phase("train") as info:
        info.update(phase_train(torch, params, card))
        tr = info["train"]
        table["lstm_gates_bwd"]["launches"] = tr["launches"]["lstm_gates_bwd"]
        for name in ("lstm_gates", "lstm_gates_bwd", "s2d_pack"):
            table[name]["launches_per_train_step"] = (
                tr["launches_per_step"][name])
        fp32_fixed = info["fixed_batch"]

    with Phase("int8_release") as info:
        info.update(phase_int8_release(torch, params, cfg, card, protocol,
                                       clips, fp32_fixed))
        qat = info["qat_finetune"]["launches_per_step"]
        for name in ("lstm_gates", "lstm_gates_bwd", "s2d_pack"):
            table[name]["launches_per_qat_step"] = qat[name]

    import shutil
    import tempfile

    os.makedirs(BUILD_DIR, exist_ok=True)
    top = tempfile.mkdtemp(prefix="smoke_folder_", dir=BUILD_DIR)
    try:
        with Phase("folder") as info:
            info.update(phase_folder(torch, params, card, pil, top))
            step = info["train"]["launches_per_step"]
            clip = info["whole_clip_eval"]["launches_per_clip"]
            for name in ("lstm_gates", "lstm_gates_bwd", "s2d_pack"):
                table[name]["launches_per_folder_train_step"] = step[name]
                table[name]["launches_per_whole_clip_720p"] = clip[name]

        with Phase("perceptual") as info:
            info.update(phase_perceptual(torch, params, card))
            step = info["train"]["launches_per_step"]
            for name in ("lstm_gates", "lstm_gates_bwd", "s2d_pack"):
                table[name]["launches_per_vgg_train_step"] = step[name]

        with Phase("import_torch") as info:
            info.update(phase_import_torch(torch, params, cfg, card))

        with Phase("parallel") as info:
            info.update(phase_parallel(torch, card,
                                       os.path.join(top, "tree"), top))
            step = info["train"]["launches_per_step"]
            clip = info["eval"]["launches_per_clip"]
            for name in ("lstm_gates", "lstm_gates_bwd", "s2d_pack"):
                table[name]["launches_per_config5_train_step"] = step[name]
                table[name]["launches_per_config5_whole_clip"] = clip[name]
            served = info["bench"]["stem4_serving"]["launches_per_clip"]
            for name in ("quantize_act", "int8_conv"):
                table[name]["launches_per_config5_clip"] = served[name]
            c5 = table["int8_conv"]["config5_per_clip"]
            require(served["int8_conv"] == c5["launches"]
                    and served["quantize_act"] == c5["quantize_launches"],
                    f"config5 serving launches {served} against the "
                    f"recorded window's {c5['launches']}")
    finally:
        shutil.rmtree(top, ignore_errors=True)

    emit({"kernels": list(table.values())})
    emit({"total_seconds": round(time.perf_counter() - t_start, 3),
          "card": card})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
