#!/usr/bin/env python3
"""K3 (the int8 implicit-GEMM conv) at other tilings, on the card, in turns.

    python3 tools/k3_ab.py --variant w64x64=K3_WARPS_N=2 \\
        --variant n256=K3_BN=256,K3_MIN_BLOCKS=1 [--rounds 3]

Each ``--variant NAME=MACRO=VALUE,...`` builds ``csrc/int8_conv.cu`` alone
with the port's nvcc flags plus those ``-D`` macros (the tiling constants
at the top of K3's section: K3_BM, K3_BN, K3_BK, K3_WARPS_M, K3_WARPS_N,
K3_STAGES, K3_MIN_BLOCKS) into ``build/k3_ab/``, all builds at once, and
prints what ptxas says of each kernel (registers, spills).  At every shape
of the serving path (``chip_smoke.int8_cases``) each variant is held bit for
bit against the plain version, then all are timed in one order and then in
the reverse order (shipped, variants, ..., variants, shipped), ``--rounds``
times; each time is a median of 20 CUDA-event runs
(``chip_smoke.device_ms``).  Prints the card's nvidia-smi line, one JSON
line per shape, and one with each version's K3 time per clip (each shape's
median times its launches per clip).  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import statistics
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def build_variants(variants: dict[str, list[str]]) -> dict:
    """Build every variant at once; returns {name: (CDLL, ptxas line)}."""
    from bin_tpu_torch.ops import native

    src = os.path.join(REPO, "bin_tpu_torch", "csrc", "int8_conv.cu")
    out_dir = os.path.join(REPO, "build", "k3_ab")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name, macros in variants.items():
        lib = os.path.join(out_dir, f"lib{name}.so")
        cmd = [native._nvcc(), *native._FLAGS, "-Xptxas", "-v",
               *(f"-D{m}" for m in macros), "-o", lib, src]
        procs[name] = (lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    built = {}
    for name, (lib, proc) in procs.items():
        _, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"variant {name}: nvcc failed\n{err}")
        info = re.findall(r"int8_conv_kernel.*?\n.*?\n.*?(Used \d+ registers"
                          r"[^\n]*)", err, re.S)
        spills = re.findall(r"int8_conv_kernel[^\n]*\n\s*(\d+ bytes stack "
                            r"frame, \d+ bytes spill stores, \d+ bytes spill "
                            r"loads)", err)
        dll = ctypes.CDLL(lib)
        dll.btt_int8_conv.argtypes = ([ctypes.c_void_p] * 7
                                      + [ctypes.c_int] * 9
                                      + [ctypes.c_void_p])
        dll.btt_int8_conv.restype = ctypes.c_int
        built[name] = (dll, {"ptxas": info[:1], "spills": spills[:1],
                             "macros": variants[name]})
    return built


def conv_with(dll, torch, args):
    """K3 of ``dll`` on ``args`` (as ``quant.int8_conv3x3`` takes them)."""
    from bin_tpu_torch.ops import native

    xq, qw, ks, sc, bias, stride, pad, out_dt, addend = args
    n, h, w, cin = xq.shape
    cout = qw.shape[0]
    out = torch.empty((n, -(-h // stride), -(-w // stride), cout),
                      dtype=out_dt, device=xq.device)
    native.check(dll.btt_int8_conv(
        xq.data_ptr(), qw.data_ptr(), sc.data_ptr(), ks.data_ptr(),
        0 if bias is None else bias.data_ptr(),
        0 if addend is None else addend.data_ptr(), out.data_ptr(),
        int(out_dt == torch.bfloat16), n, h, w, cin, cout, stride, pad[0],
        pad[1], native.stream(xq.device)), "variant btt_int8_conv")
    return out


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--variant", action="append", default=[],
                   metavar="NAME=MACRO=VALUE,...")
    p.add_argument("--rounds", type=int, default=3)
    args = p.parse_args()

    import torch

    import chip_smoke
    from bin_tpu_torch.models.layers import _same_pad
    from bin_tpu_torch.ops import quant
    from bin_tpu_torch.weights import load_weights

    if not torch.cuda.is_available():
        print("k3_ab: needs a CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    variants = {"shipped": []}
    for v in args.variant:
        name, _, macros = v.partition("=")
        variants[name] = [m for m in macros.split(",") if m]
    built = build_variants(variants)
    for name, (_, info) in built.items():
        print(json.dumps({"variant": name, **info}), flush=True)

    _, cfg, _ = load_weights(chip_smoke.WEIGHTS)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    scale = torch.tensor(0.015, device=dev)
    names = list(built)
    order = names + names[::-1]
    per_clip = {name: 0.0 for name in names}
    for (case, shape, cout, stride, in_dt, out_dt, has_bias, has_addend,
         per) in chip_smoke.int8_cases(torch, cfg):
        if not per:
            continue
        n, h, w, cin = shape
        ho, wo = -(-h // stride), -(-w // stride)
        pad = (_same_pad(h, 3, stride)[0], _same_pad(w, 3, stride)[0])
        x = (torch.randn(shape, device=dev, generator=gen) * 0.5).to(in_dt)
        qw, ks = quant.quantize_weight(
            torch.randn(cout, cin, 3, 3, device=dev, generator=gen) * 0.05)
        bias = (torch.randn(cout, device=dev, generator=gen)
                if has_bias else None)
        addend = (torch.randn(n, ho, wo, cout, device=dev, generator=gen)
                  if has_addend else None)
        cargs = (quant.quantize_act(x, scale), qw, ks, scale, bias, stride,
                 pad, out_dt, addend)
        ref = quant.int8_conv3x3_ref(*cargs)
        for name in names:
            out = conv_with(built[name][0], torch, cargs)
            if not torch.equal(out, ref):
                raise AssertionError(f"{name} at {case}: not bit-exact")
        times = {name: [] for name in names}
        for _ in range(args.rounds):
            for name in order:
                dll = built[name][0]
                times[name].append(chip_smoke.device_ms(
                    torch, lambda: conv_with(dll, torch, cargs)))
        ops = 2 * n * ho * wo * cout * 9 * cin
        row = {"case": case, "x": list(shape), "cout": cout,
               "stride": stride, "launches_per_clip": per, "ops": ops}
        for name in names:
            med = statistics.median(times[name])
            row[name] = {"ms": med, "runs": times[name],
                         "tops": ops / med / 1e9}
            per_clip[name] += per * med
        print(json.dumps(row), flush=True)
    print(json.dumps({"k3_ms_per_clip": per_clip}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
