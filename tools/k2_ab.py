#!/usr/bin/env python3
"""K2 (the input pack) against other versions of its CUDA source, on the
card, in turns.

    git show <commit>:bin_tpu_torch/csrc/s2d_pack.cu > build/k2_ab/pr4.cu
    python3 tools/k2_ab.py --baseline build/k2_ab/pr4.cu \\
        [--candidate build/k2_ab/variant.cu ...] [--rounds 3]

``--baseline`` is the one-word-a-thread kernel of PR 4, whose C entry
point is ``btt_s2d_pack(x, out, n, h, w, f, run_bytes, word_bytes, stream)``
(the word the widest that divides a run and both addresses).  Each
``--candidate`` has the current entry point and takes the current
``pixel_shuffle.pack_plan``.  Each source is built alone with the port's
nvcc flags into ``build/k2_ab/``.  For each clip shape (1, 8, 720, 1280, 3)
at bf16 (the main path), u8 and fp32, f=2, every version is held bit-exact
against the plain version, then all are timed in one order and then in the
reverse order (current, baseline, candidates, ..., baseline, current),
``--rounds`` times, beside the plain version and ``view.permute.contiguous``;
each time is a median of 20 CUDA-event runs (``chip_smoke.device_ms``).
Prints the card's nvidia-smi line, then one JSON line per shape.  Needs a
CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

CLIP = (1, 8, 720, 1280, 3)


def build_alone(source: str) -> ctypes.CDLL:
    from bin_tpu_torch.ops import native

    name = os.path.splitext(os.path.basename(source))[0]
    lib = os.path.join(REPO, "build", "k2_ab", f"lib{name}.so")
    os.makedirs(os.path.dirname(lib), exist_ok=True)
    subprocess.run([native._nvcc(), *native._FLAGS, "-o", lib, source],
                   check=True)
    return ctypes.CDLL(lib)


def empty_out(torch, x, f):
    *lead, h, w, c = x.shape
    return torch.empty((*lead, h // f, w // f, f * f * c), dtype=x.dtype,
                       device=x.device)


def baseline_pack(dll, torch, x, f):
    from bin_tpu_torch.ops import native

    *_, h, w, c = x.shape
    out = empty_out(torch, x, f)
    run = f * c * x.element_size()
    word = next(wd for wd in (16, 8, 4, 2, 1) if run % wd == 0
                and x.data_ptr() % wd == 0 and out.data_ptr() % wd == 0)
    native.check(dll.btt_s2d_pack(x.data_ptr(), out.data_ptr(),
                                  x.numel() // (h * w * c), h, w, f, run,
                                  word, native.stream(x.device)),
                 "baseline btt_s2d_pack")
    return out


def candidate_pack(dll, torch, x, f):
    from bin_tpu_torch.ops import native, pixel_shuffle

    *_, w, c = x.shape
    out = empty_out(torch, x, f)
    row, run = w * c * x.element_size(), f * c * x.element_size()
    plan = pixel_shuffle.pack_plan(row, run, f, x.data_ptr(), out.data_ptr())
    native.check(dll.btt_s2d_pack(x.data_ptr(), out.data_ptr(),
                                  x.numel() // (w * c * f), f, row, run,
                                  *plan, native.stream(x.device)),
                 "candidate btt_s2d_pack")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", help="PR 4's bin_tpu_torch/csrc/s2d_pack.cu")
    ap.add_argument("--candidate", action="append", default=[],
                    help="a source with the current entry point")
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()

    import torch

    from bin_tpu_torch.ops import pixel_shuffle
    from chip_smoke import bound_ms, device_ms

    if not torch.cuda.is_available():
        print("k2_ab: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    packs = {"current": lambda x, f: pixel_shuffle.space_to_depth(x, f)}
    if args.baseline:
        dll = build_alone(args.baseline)
        dll.btt_s2d_pack.argtypes = [vp, vp, i64, i32, i32, i32, i32, i32, vp]
        packs["baseline"] = (
            lambda x, f, dll=dll: baseline_pack(dll, torch, x, f))
    for src in args.candidate:
        dll = build_alone(src)
        dll.btt_s2d_pack.argtypes = [vp, vp, i64, i32, i64, i32, i32, i32,
                                     i32, vp]
        packs[os.path.basename(src)] = (
            lambda x, f, dll=dll: candidate_pack(dll, torch, x, f))
    order = list(packs) + list(packs)[::-1]
    gen = torch.Generator(device="cuda").manual_seed(0)
    f = 2
    n, k, h, w, ch = CLIP
    for dt in (torch.bfloat16, torch.uint8, torch.float32):
        if dt == torch.uint8:
            x = torch.randint(0, 256, CLIP, device="cuda", generator=gen,
                              dtype=dt)
        else:
            x = torch.rand(CLIP, device="cuda", generator=gen).to(dt)
        ref = pixel_shuffle.space_to_depth_ref(x, f)
        for name, pack in packs.items():
            if not torch.equal(pack(x, f), ref):
                raise AssertionError(f"{name} {dt}: not bit-exact")
        ms = {name: [] for name in packs}
        ms.update(plain=[], library=[])
        for _ in range(args.rounds):
            for name in order:
                ms[name].append(device_ms(torch, lambda: packs[name](x, f)))
            ms["plain"].append(device_ms(
                torch, lambda: pixel_shuffle.space_to_depth_ref(x, f)))
            ms["library"].append(device_ms(torch, lambda: x.view(
                n * k, h // f, f, w // f, f, ch).permute(0, 1, 3, 2, 4, 5)
                .contiguous()))
        bound = bound_ms(2 * x.nbytes, 0)[0]
        med = {name: statistics.median(v) for name, v in ms.items()}
        print(json.dumps({
            "card": card, "shape": list(CLIP), "dtype": str(dt), "factor": f,
            "bound_ms": bound, "median_ms": med,
            "share_of_bound": {name: bound / v for name, v in med.items()},
            "runs_ms": ms}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
