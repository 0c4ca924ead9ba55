#!/usr/bin/env python3
"""K1 and K1b (the ConvLSTM gate update and its backward) against an earlier
version, on the card, in turns.

    git show 17563ba:bin_tpu_torch/csrc/lstm_gates.cu > build/k1_ab/old.cu
    python3 tools/k1_ab.py --baseline build/k1_ab/old.cu \\
        [--variant w1=K1_GRID_WAVES=1 ...] [--ablate math]
        [--plan VEC:THREADS ...] [--rounds 5]

``--baseline`` is an earlier ``csrc/lstm_gates.cu`` whose entry points take
no plan: ``btt_lstm_gates(gates, gates_bf16, c, h_out, c_out, rows, feat,
forget_bias, stream)`` and ``btt_lstm_gates_bwd(gates, gates_bf16, c, dh,
dc_out, dgates, dc, rows, feat, forget_bias, stream)`` (one thread an
element, the kernels of 17563ba).  Each ``--variant NAME=MACRO=VALUE,...``
builds the current source with those ``-D`` macros (``K1_GRID_WAVES``: the
grid's cap in waves of what the card holds at once).  ``--ablate math``
builds a copy whose arithmetic is cut to a sum of the inputs (every load
and store kept), to time the data movement alone; it is timed but not held
to the plain version.  ``--plan VEC:THREADS`` also times the current source
and each variant at that vector width and block size, where it fits.
Every source builds alone with the port's nvcc flags into
``build/k1_ab/``, all at once; ptxas's registers and spills of each kernel
are printed, and, where the toolkit has ``cuobjdump``, each kernel's
global loads and stores by width from its SASS.

At the nine shapes of PERF.md's K1 and K1b rows (K1: (1,90,160,1024) bf16,
(4,16,16,1024) bf16 and fp32, (1,45,80,1024) bf16, (8,8,8,1024) bf16; K1b:
(8,8,8,1024) bf16, (4,16,16,1024) bf16 and fp32, (1,90,160,1024) bf16)
each version is held against the plain version (K1 within 1e-5, K1b within
``chip_smoke.K1B_ATOL`` and a bf16 rounding), then all are timed in one
order and then in the reverse one (shipped, variants, baseline, baseline,
variants, shipped), ``--rounds`` times; each time is a median of 20
CUDA-event runs
(``chip_smoke.device_ms``), beside an empty launch timed the same way.
Prints the card's nvidia-smi line, one JSON line per version, one per
shape and a summary with each version's medians.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import shutil
import statistics
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
SOURCE = os.path.join(REPO, "bin_tpu_torch", "csrc", "lstm_gates.cu")
OUT = os.path.join(REPO, "build", "k1_ab")

# (kernel, lead shape, F, gates dtype): PERF.md's nine K1 and K1b rows
# --ablate math: the kernels' arithmetic cut to what keeps every load and
# store (each output a sum of its inputs), to time the data movement alone
_K1_MATH = ("""      const float n = sigmoid(gf.get(e) + forget_bias) * ck.get(e) +
                      sigmoid(gi.get(e)) * tanhf(gg.get(e));
      h.set(e, sigmoid(go.get(e)) * tanhf(n));
      nc.set(e, n);""", """      h.set(e, gi.get(e) + gf.get(e) + gg.get(e) + go.get(e));
      nc.set(e, ck.get(e) + forget_bias);""")
_K1B_MATH = ("""      const float si = sigmoid(gi.get(e));
      const float sf = sigmoid(gf.get(e) + forget_bias);
      const float tg = tanhf(gg.get(e));
      const float so = sigmoid(go.get(e));""", """      const float si = gi.get(e);
      const float sf = gf.get(e) + forget_bias;
      const float tg = gg.get(e);
      const float so = go.get(e);""")
_K1B_TANH = ("""      const float tc = tanhf(sf * cv + si * tg);""",
             """      const float tc = sf * cv + si * tg;""")
ABLATIONS = {"math": [_K1_MATH, _K1B_MATH, _K1B_TANH]}

SHAPES = [("K1", (1, 90, 160), 256, "bfloat16"),
          ("K1", (4, 16, 16), 256, "bfloat16"),
          ("K1", (1, 45, 80), 256, "bfloat16"),
          ("K1", (8, 8, 8), 256, "bfloat16"),
          ("K1", (4, 16, 16), 256, "float32"),
          ("K1b", (8, 8, 8), 256, "bfloat16"),
          ("K1b", (4, 16, 16), 256, "bfloat16"),
          ("K1b", (4, 16, 16), 256, "float32"),
          ("K1b", (1, 90, 160), 256, "bfloat16")]


def ablated(name: str) -> str:
    """A copy of the current source without ``name``'s parts, in
    build/k1_ab/; raises if the source no longer has their text."""
    text = open(SOURCE).read()
    for old, new in ABLATIONS[name]:
        if text.count(old) != 1:
            raise RuntimeError(f"--ablate {name}: csrc/lstm_gates.cu changed;"
                               " update tools/k1_ab.py ABLATIONS")
        text = text.replace(old, new)
    path = os.path.join(OUT, f"ablate_{name}.cu")
    os.makedirs(OUT, exist_ok=True)
    with open(path, "w") as f:
        f.write(text)
    return path


def ptxas_info(log: str) -> list[dict]:
    """Registers and spills of each K1/K1b kernel in an ``-Xptxas -v``
    log."""
    rows = []
    for name, body in re.findall(
            r"Compiling entry function '(\w*lstm_gates\w*)'.*?\n"
            r"(.*?)(?=Compiling entry function|\Z)", log, re.S):
        regs = re.search(r"Used (\d+) registers", body)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", body)
        rows.append({"kernel": name,
                     "registers": int(regs.group(1)) if regs else None,
                     "spill_bytes": [int(v) for v in spill.groups()]
                     if spill else None})
    return rows


def sass_accesses(lib: str) -> dict | str:
    """Each K1/K1b kernel's global load and store instructions by opcode
    (``LDG.E.128`` is a 16-byte load) from ``cuobjdump -sass``."""
    from bin_tpu_torch.ops import native

    tool = os.path.join(os.path.dirname(native._nvcc()), "cuobjdump")
    if not os.path.exists(tool):
        tool = shutil.which("cuobjdump")
    if not tool:
        return "cuobjdump not found"
    sass = subprocess.run([tool, "-sass", lib], capture_output=True,
                          text=True).stdout
    out = {}
    for name, body in re.findall(r"Function : (\S*lstm_gates\S*)\n(.*?)"
                                 r"(?=Function : |\Z)", sass, re.S):
        ops = re.findall(r"\b((?:LDG|STG)\.E[\w.]*)", body)
        out[name] = {op: ops.count(op) for op in sorted(set(ops))}
    return out


def build_all(versions: dict[str, tuple[str, list[str]]]) -> dict:
    """Build every (source, macros) at once; returns {name: (CDLL, info)}."""
    from bin_tpu_torch.ops import native

    os.makedirs(OUT, exist_ok=True)
    procs = {}
    for name, (src, macros) in versions.items():
        lib = os.path.join(OUT, f"lib{name}.so")
        cmd = [native._nvcc(), *native._FLAGS, "-Xptxas", "-v",
               *(f"-D{m}" for m in macros), "-o", lib, src]
        procs[name] = (lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    built = {}
    for name, (lib, proc) in procs.items():
        _, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{err}")
        built[name] = (ctypes.CDLL(lib),
                       {"source": os.path.relpath(versions[name][0], REPO),
                        "macros": versions[name][1],
                        "kernels": ptxas_info(err),
                        "sass_global_accesses": sass_accesses(lib)})
    return built


def bind(dll, baseline: bool) -> None:
    vp, i32, i64, f32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
                         ctypes.c_float)
    plan = [] if baseline else [i32, i32]
    dll.btt_lstm_gates.argtypes = [vp, i32, vp, vp, vp, i64, i32, f32,
                                   *plan, vp]
    dll.btt_lstm_gates_bwd.argtypes = [vp, i32, vp, vp, vp, vp, vp, i64,
                                       i32, f32, *plan, vp]
    dll.btt_lstm_gates.restype = dll.btt_lstm_gates_bwd.restype = i32


def call(dll, baseline: bool, torch, kernel: str, args, force=None):
    """K1 (args gates, c) or K1b (gates, c, dh, dc_out) of ``dll``, at the
    plan's (vec, threads) or at ``force``'s, where ``vec`` is no wider than
    the plan's."""
    from bin_tpu_torch.ops import lstm_gates, native

    gates, *state = args
    feat = state[0].shape[-1]
    rows = state[0].numel() // feat
    outs = ((torch.empty_like(gates), torch.empty_like(state[0]))
            if kernel == "K1b" else
            (torch.empty_like(state[0]), torch.empty_like(state[0])))
    plan = lstm_gates.k1_plan(
        rows, feat, gates.dtype,
        (gates.data_ptr(),) + ((outs[0].data_ptr(),) if kernel == "K1b"
                               else ()),
        tuple(t.data_ptr() for t in state)
        + tuple(t.data_ptr() for t in outs[kernel == "K1b":]))
    if force and force[0] > plan["vec"]:
        raise ValueError(f"vec {force[0]} wider than the plan's {plan}")
    extra = [] if baseline else list(force or (plan["vec"], plan["threads"]))
    fn = dll.btt_lstm_gates_bwd if kernel == "K1b" else dll.btt_lstm_gates
    err = fn(gates.data_ptr(), int(gates.dtype == torch.bfloat16),
             *(t.data_ptr() for t in state), *(t.data_ptr() for t in outs),
             rows, feat, 1.0, *extra, native.stream(gates.device))
    native.check(err, kernel)
    return outs


def holds(torch, kernel: str, args, outs) -> tuple[bool, float]:
    """The outputs against the plain version, within the smoke's bounds."""
    import chip_smoke
    from bin_tpu_torch.ops import lstm_gates

    gates = args[0]
    if kernel == "K1":
        ref = lstm_gates.lstm_gate_math_ref(*args)
        err = max((o - r).abs().max().item() for o, r in zip(outs, ref))
        return err <= 1e-5, err
    dg_r, dc_r = lstm_gates.lstm_gates_bwd_ref(gates.float(), *args[1:])
    dg_err = (outs[0].float() - dg_r).abs()
    bound = chip_smoke.K1B_ATOL + (dg_r.abs() * 2.0 ** -8
                                   if gates.dtype == torch.bfloat16 else 0.0)
    dc_err = (outs[1] - dc_r).abs().max().item()
    err = max(dg_err.max().item(), dc_err)
    return (bool((dg_err <= bound).all())
            and dc_err <= chip_smoke.K1B_ATOL), err


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--baseline", help="an earlier csrc/lstm_gates.cu whose "
                   "entry points take no plan")
    p.add_argument("--variant", action="append", default=[],
                   metavar="NAME=MACRO=VALUE,...")
    p.add_argument("--ablate", default="",
                   help="comma-separated cuts: " + ",".join(ABLATIONS))
    p.add_argument("--plan", action="append", default=[],
                   metavar="VEC:THREADS", help="also time the shipped "
                   "source and each variant at this vec and block size "
                   "where it fits")
    p.add_argument("--rounds", type=int, default=5)
    args = p.parse_args()

    import torch

    import chip_smoke

    if not torch.cuda.is_available():
        print("k1_ab: needs a CUDA device", file=sys.stderr)
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
    for cut in (c for c in args.ablate.split(",") if c):
        versions[f"no_{cut}"] = (ablated(cut), [])
    built = build_all(versions)
    for name, (dll, info) in built.items():
        bind(dll, name == "baseline")
        print(json.dumps({"version": name, **info}), flush=True)
    # (dll, baseline, forced plan) of each timed version
    runs = {name: (dll, name == "baseline", None)
            for name, (dll, _) in built.items()}
    for spec in args.plan:
        vec, threads = map(int, spec.split(":"))
        for name, (dll, _) in built.items():
            if name != "baseline" and not name.startswith("no_"):
                runs[f"{name}@{vec}:{threads}"] = (dll, False,
                                                   (vec, threads))

    gen = torch.Generator(device="cuda").manual_seed(3)
    names = list(runs)
    order = names + names[::-1]
    floor = chip_smoke.device_ms(torch, lambda: torch.cuda._sleep(0))
    summary = {name: {} for name in names}
    for kernel, shape, feat, dt in SHAPES:
        cargs = chip_smoke.lstm_inputs(torch, gen, shape, feat, dt,
                                       extra=2 if kernel == "K1b" else 0)
        gates, c = cargs[:2]
        if kernel == "K1":
            nbytes = gates.nbytes + 3 * c.nbytes
            flops = chip_smoke.K1_FLOPS_PER_ELEMENT * c.numel()
        else:
            nbytes = 2 * gates.nbytes + 4 * c.nbytes
            flops = chip_smoke.K1B_FLOPS_PER_ELEMENT * c.numel()
        b_ms, b_by = chip_smoke.bound_ms(nbytes, flops)
        row = {"card": card, "kernel": kernel, "gates": list(gates.shape),
               "dtype": dt, "bytes": nbytes, "bound_ms": b_ms,
               "bound_by": b_by, "floor_ms": floor}
        plan = chip_smoke.lstm_plan(*cargs)
        fits = [n for n in names if not runs[n][2]
                or runs[n][2][0] <= plan["vec"]]
        for name in fits:
            dll, base, force = runs[name]
            ok, err = holds(torch, kernel, cargs,
                            call(dll, base, torch, kernel, cargs, force))
            if not ok and not name.startswith("no_"):
                raise AssertionError(f"{name} {kernel} {shape} {dt}: max "
                                     f"abs diff {err} over its bound")
            row[name] = {"holds": ok, "max_abs_diff": err}
        times = {name: [] for name in fits}
        for _ in range(args.rounds):
            for name in (n for n in order if n in fits):
                dll, base, force = runs[name]
                times[name].append(chip_smoke.device_ms(
                    torch, lambda: call(dll, base, torch, kernel, cargs,
                                        force)))
        key = f"{kernel} {tuple(gates.shape)} {dt}"
        row["plan"] = plan
        for name in fits:
            med = statistics.median(times[name])
            row[name].update(ms=med, runs=times[name],
                             share_of_bound=b_ms / med)
            summary[name][key] = med
        print(json.dumps(row), flush=True)
    print(json.dumps({"card": card, "floor_ms": floor, "median_ms": summary}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
