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
            within 1e-5; K3q and K3 exact at every shape of the serving
            path and at ragged and odd ones, K3 also with the LeakyReLU and
            the residual add in its epilogue, each case checked more than
            once on freshly poisoned output memory), with its time, the plain
            version's, its bound and share of it and the PyTorch calls that
            compute the same function (K2: a permutation copy; K3: the
            im2col + ``torch._int_mm`` route, and cuDNN's bf16 conv of the
            shape for scale), and K3's and K3q's time per clip;
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
            120 u8 keys, free-running and then synchronized per key, each
            frame against ``infer_clip`` of the same keys bit for bit as it
            arrives, the launches of each key, the stream's ms per key over
            all keys, each key's latency, the pinned memory grown and peak
            memory;
9. http     ``bin-tpu-serve``'s ``make_http_server`` on 127.0.0.1 and a
            ``StreamClient``, serving mode: one 720p stream of 120 keys,
            after a warm-up stream, equal bit for bit to a direct session,
            the stream's ms per key over all keys.

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
INT8_OPS_PER_S = 1979e12             # H100 SXM, dense int8 tensor cores
# flops of one K1 output element: f + bias; three sigmoids at 3 each (exp,
# add, divide); two tanh at 1 each; three multiplies and one add
K1_FLOPS_PER_ELEMENT = 1 + 3 * 3 + 2 + 4
BUDGET_S = {"device": 30, "build": 60, "kernels": 120, "card_vs_cpu": 120,
            "slice": 240, "serving": 240, "quality": 150, "streaming": 90,
            "http": 60}
# the pinned protocol's psnr_overall measured with bin_tpu: bf16 from the
# release card (weights/prf_ema_r4.card.json), the serving mode from
# BASELINE.md's static-scales table; 0.05 dB is the repo's quality budget
# (BASELINE.json)
QUALITY_PSNR = {"bf16": 28.5775, "serving": 28.5732}
QUALITY_BUDGET_DB = 0.05
CARD_SSIM = 0.8019                   # reported beside the port's, not gated
SSIM_CARD_VS_CPU_ATOL = 1e-5
# keys of a timed stream: at ~25-30 ms a key on an H100, ~3-4 s a stream
STREAM_KEYS = HTTP_KEYS = 120


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


def bound_ms(nbytes: int, flops: int,
             ops_per_s: float = FP32_FLOPS_PER_S) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_kernels(torch, cfg) -> dict:
    from bin_tpu_torch.ops import lstm_gates, pixel_shuffle

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    f_lstm = cfg.convlstm_features
    down = cfg.stem_factor * 2 ** (len(cfg.channel_mult) - 1)
    hb, wb = CLIP[2] // down, CLIP[3] // down
    eval_clip = eval_clip_shape(cfg)
    ehb, ewb = eval_clip[2] // down, eval_clip[3] // down
    table = {}

    # K1 at the main path's shape (the 720p clip's and key's) and at the
    # eval clip's, from bf16 gates (the model) and fp32
    cases, k1_err = [], 0.0
    for path, shape, feat, dt in [
            ("720p", (1, hb, wb), f_lstm, torch.bfloat16),
            ("720p", (1, hb, wb), f_lstm, torch.float32),
            ("eval", (1, ehb, ewb), f_lstm, torch.bfloat16),
            ("eval", (1, ehb, ewb), f_lstm, torch.float32),
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
        lstm_gates.launches = pixel_shuffle.launches = 0
        quant.quantize_launches = quant.conv_launches = 0
    return {"lstm_gates": lstm_gates.launches,
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
                 {"lstm_gates": 9, "s2d_pack": 1, "quantize_act": 0,
                  "int8_conv": 0}),
                ("int8 float32", serving_config(cfg, "float32"),
                 {"lstm_gates": 9, "s2d_pack": 1, "quantize_act": 135,
                  "int8_conv": 135})]:
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
    return {"lstm_gates": levels, "s2d_pack": 0, "quantize_act": convs,
            "int8_conv": convs}


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


def phase_quality(torch, cfg, bf16_model, serving_model) -> dict:
    """The pinned protocol on the release weights, through ``evaluate``, in
    bf16 and in the serving mode, on clips rendered once; then SSIM on the
    card against the CPU on the first clip's frames."""
    from bin_tpu_torch import metrics
    from bin_tpu_torch.config import Config, DataConfig
    from bin_tpu_torch.data import eval_clips
    from bin_tpu_torch.evaluation import evaluate
    from bin_tpu_torch.evaluation.evaluator import (clip_metrics_fn,
                                                    protocol_source)

    t0 = time.perf_counter()
    protocol, source = protocol_source(Config(model=cfg, data=DataConfig()))
    clips = list(eval_clips(Rendered(source, os.cpu_count() or 1)))
    out = {"protocol": protocol, "render_seconds": time.perf_counter() - t0,
           "card_ssim_overall": CARD_SSIM}
    windows = protocol["keys"] - cfg.window_size + 1
    for mode, model in (("bf16", bf16_model), ("serving", serving_model)):
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
        out[mode] = {**res, "dtype": model.cfg.dtype,
                     "int8": model.cfg.conv_int8,
                     "target_psnr_overall": QUALITY_PSNR[mode],
                     "delta_db": delta, "budget_db": QUALITY_BUDGET_DB,
                     "seconds": sec, "launches": launches}
        require(abs(delta) <= QUALITY_BUDGET_DB,
                f"quality {mode}: psnr_overall {res['psnr_overall']:.4f} is "
                f"{delta:+.4f} dB from {QUALITY_PSNR[mode]}")

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
            "lstm_gates": 15, "s2d_pack": 1, "quantize_act": 0,
            "int8_conv": 0}, card)
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
        info.update(phase_quality(torch, cfg, bf16_model, serving_model))

    with Phase("streaming") as info:
        info.update(phase_streaming(torch, serving_model, bf16_model))
        per_key = info["serving"]["launches_per_key"]
        for name, n in per_key.items():
            table[name]["launches_per_key"] = n
        table["s2d_pack"]["per_key_u8"]["launches_per_key"] = (
            per_key["s2d_pack"])

    with Phase("http") as info:
        info.update(phase_http(torch, serving_model))

    emit({"kernels": list(table.values())})
    emit({"total_seconds": round(time.perf_counter() - t_start, 3),
          "card": card})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
