#!/usr/bin/env python3
"""K3 (the int8 implicit-GEMM conv) against other versions, on the card, in
turns.

    git show <commit>:bin_tpu_torch/csrc/int8_conv.cu > build/k3_ab/old.cu
    python3 tools/k3_ab.py --baseline build/k3_ab/old.cu \\
        [--variant st3=K3_MAX_STAGES=3 ...] [--ablate epilogue,loads,mma]
        [--rounds 3]

``--baseline`` is an earlier ``csrc/int8_conv.cu`` whose C entry point has
no epilogue arguments: ``btt_int8_conv(x, wt, ascale, kscale, bias, addend,
out, out_bf16, n, h, w, cin, cout, stride, pt, pl, stream)`` (the
``mma.sync`` kernel of 405c2e7, for one).  Each ``--variant
NAME=MACRO=VALUE,...`` builds the current source with those ``-D`` macros
(the tiling constants at the top of K3's section: K3_BH, K3_BW,
K3_MAX_STAGES, K3_PRODUCER_REGS, K3_EPI_BATCH).  ``--ablate`` builds copies
of the current source with parts cut out, to see what the kernel waits on:
``epilogue`` (the sums are kept but nothing is stored), ``loads`` (no TMA
load: the wgmma runs on whatever the ring holds; no epilogue) and ``mma``
(no wgmma: the ring is loaded and freed; no epilogue); these are timed but,
computing something else, not held to the plain version.  Every source
builds alone with the port's nvcc flags into
``build/k3_ab/``, all at once, and ptxas's registers and spills of each
kernel are printed.  At every shape of the 720p clip's serving path
(``chip_smoke.int8_cases``) each version is held bit for bit against the
plain version, then all are timed in one order and then in the reverse
order (shipped, variants, baseline, ..., baseline, variants, shipped),
``--rounds`` times; each time is a median of 20 CUDA-event runs
(``chip_smoke.device_ms``).  Prints the card's nvidia-smi line, one JSON
line per shape, and one with each version's K3 time per clip (each
shape's median times its launches per clip).  Needs a CUDA device.
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
SOURCE = os.path.join(REPO, "bin_tpu_torch", "csrc", "int8_conv.cu")

# --ablate: (text of the current source, its replacement) per cut
_EPILOGUE = ("""      for (int sl = 0; sl < SLABS; ++sl)
        epilogue(p, t, cols, sl * 64, cw, ct, staging, acc[sl]);""",
             """      for (int sl = 0, sum = t.n + (int)cols.s[0][0]; sl < SLABS;
           ++sl) {  // ablated: keep the sums alive, store nothing
        for (int j = 0; j < BN / 2; ++j) sum += acc[sl][j];
        if (sum == 0x7fffffff) static_cast<int*>(p.out)[0] = sum;
      }""")
_LOADS = ("""          mbar_expect_tx(full(stage), T::STAGE);
          tma_load_4d(a, &xmap, full(stage), c0, x0 + kw, y0 + kh, t.n);
          tma_load_2d(a + T::A_BYTES, &wmap, full(stage), tap * p.cin + c0,
                      t.n0);""",
          """          mbar_arrive(full(stage));  // ablated: no load
          (void)a, (void)c0, (void)kh, (void)kw, (void)x0, (void)y0;""")
_MMA = ("""        for (int ks = 0; ks < CK / 32; ++ks)
#pragma unroll
          for (int sl = 0; sl < SLABS; ++sl)
            wgmma_n128(acc[sl], wgmma_desc<CK>(a + sl * 64 * CK + 32 * ks),
                       wgmma_desc<CK>(b + 32 * ks), (kb | ks) != 0);""",
        """        for (int ks = 0; ks < 0; ++ks) acc[0][0] += a + b;  // ablated""")
ABLATIONS = {"epilogue": [_EPILOGUE], "loads": [_EPILOGUE, _LOADS],
             "mma": [_EPILOGUE, _MMA]}


def ablated(name: str) -> str:
    """A copy of the current source without ``name``'s parts, in
    build/k3_ab/; raises if the source no longer has their text."""
    text = open(SOURCE).read()
    for old, new in ABLATIONS[name]:
        if text.count(old) != 1:
            raise RuntimeError(f"--ablate {name}: csrc/int8_conv.cu changed; "
                               "update tools/k3_ab.py ABLATIONS")
        text = text.replace(old, new)
    path = os.path.join(REPO, "build", "k3_ab", f"ablate_{name}.cu")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write(text)
    return path


def ptxas_info(log: str) -> list[dict]:
    """Registers and spills of each K3 kernel in an ``-Xptxas -v`` log."""
    rows = []
    for name, body in re.findall(
            r"Compiling entry function '(\w*int8_conv_kernel\w*)'.*?\n"
            r"(.*?)(?=Compiling entry function|\Z)", log, re.S):
        regs = re.search(r"Used (\d+) registers", body)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", body)
        rows.append({"kernel": name,
                     "registers": int(regs.group(1)) if regs else None,
                     "spill_bytes": [int(v) for v in spill.groups()]
                     if spill else None})
    return rows


def build_all(versions: dict[str, tuple[str, list[str]]]) -> dict:
    """Build every (source, macros) at once; returns {name: (CDLL, info)}."""
    from bin_tpu_torch.ops import native

    out_dir = os.path.join(REPO, "build", "k3_ab")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name, (src, macros) in versions.items():
        lib = os.path.join(out_dir, f"lib{name}.so")
        cmd = [native._nvcc(), *native._FLAGS, "-Xptxas", "-v",
               *(f"-D{m}" for m in macros), "-o", lib, src]
        procs[name] = (lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    built = {}
    for name, (lib, proc) in procs.items():
        _, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{err}")
        warnings = [ln for ln in err.splitlines()
                    if "warning" in ln.lower() or "serialized" in ln]
        built[name] = (ctypes.CDLL(lib),
                       {"source": os.path.relpath(versions[name][0], REPO),
                        "macros": versions[name][1],
                        "kernels": ptxas_info(err), "warnings": warnings})
    return built


def bind(dll, baseline: bool) -> None:
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    dll.btt_int8_conv.argtypes = ([vp] * 7 + [i32] * 9 + [vp] if baseline
                                  else [vp] * 8 + [i32] * 11
                                  + [ctypes.c_float, vp])
    dll.btt_int8_conv.restype = i32


def conv_with(dll, baseline: bool, torch, args):
    """K3 of ``dll`` on ``args`` (as ``quant.int8_conv3x3`` takes them, no
    epilogue arguments)."""
    from bin_tpu_torch.ops import native

    xq, qw, ks, sc, bias, stride, pad, out_dt, addend = args
    n, h, w, cin = xq.shape
    cout = qw.shape[0]
    out = torch.empty((n, -(-h // stride), -(-w // stride), cout),
                      dtype=out_dt, device=xq.device)
    ptrs = [xq.data_ptr(), qw.data_ptr(), sc.data_ptr(), ks.data_ptr(),
            0 if bias is None else bias.data_ptr(),
            0 if addend is None else addend.data_ptr()]
    dims = [int(out_dt == torch.bfloat16), n, h, w, cin, cout, stride,
            pad[0], pad[1]]
    if baseline:
        err = dll.btt_int8_conv(*ptrs, out.data_ptr(), *dims,
                                native.stream(xq.device))
    else:  # the current entry point also takes Ho, after W
        dims.insert(4, out.shape[1])
        err = dll.btt_int8_conv(*ptrs, 0, out.data_ptr(), *dims, 0, 0.0,
                                native.stream(xq.device))
    native.check(err, "btt_int8_conv")
    return out


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--baseline", help="an earlier csrc/int8_conv.cu with the "
                   "entry point of no epilogue arguments")
    p.add_argument("--variant", action="append", default=[],
                   metavar="NAME=MACRO=VALUE,...")
    p.add_argument("--ablate", default="",
                   help="comma-separated cuts: " + ",".join(ABLATIONS))
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
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card, flush=True)
    versions = {"shipped": (SOURCE, [])}
    for v in args.variant:
        name, _, macros = v.partition("=")
        versions[name] = (SOURCE, [m for m in macros.split(",") if m])
    if args.baseline:
        versions["baseline"] = (os.path.abspath(args.baseline), [])
    cuts = [c for c in args.ablate.split(",") if c]
    for cut in cuts:
        versions[f"no_{cut}"] = (ablated(cut), [])
    built = build_all(versions)
    for name, (dll, info) in built.items():
        bind(dll, name == "baseline")
        print(json.dumps({"version": name, **info}), flush=True)

    _, cfg, _ = load_weights(chip_smoke.WEIGHTS)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    scale = torch.tensor(0.015, device=dev)
    names = list(built)
    order = names + names[::-1]
    per_clip = {name: 0.0 for name in names}
    for (case, shape, cout, stride, in_dt, out_dt, has_bias, has_addend,
         per, path) in chip_smoke.int8_cases(torch, cfg):
        if path != "720p":  # the clip bench.py times
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
            out = conv_with(built[name][0], name == "baseline", torch, cargs)
            if not name.startswith("no_") and not torch.equal(out, ref):
                raise AssertionError(f"{name} at {case}: not bit-exact")
        times = {name: [] for name in names}
        for _ in range(args.rounds):
            for name in order:
                dll, base = built[name][0], name == "baseline"
                times[name].append(chip_smoke.device_ms(
                    torch, lambda: conv_with(dll, base, torch, cargs)))
        ops = 2 * n * ho * wo * cout * 9 * cin
        row = {"card": card, "case": case, "x": list(shape), "cout": cout,
               "stride": stride, "launches_per_clip": per, "ops": ops,
               "bound_ms": ops / chip_smoke.INT8_OPS_PER_S * 1e3}
        for name in names:
            med = statistics.median(times[name])
            row[name] = {"ms": med, "runs": times[name],
                         "tops": ops / med / 1e9,
                         "share_of_bound": row["bound_ms"] / med}
            per_clip[name] += per * med
        print(json.dumps(row), flush=True)
    print(json.dumps({"card": card, "k3_ms_per_clip": per_clip}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
