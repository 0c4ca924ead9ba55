#!/usr/bin/env python3
"""Does ``chip_smoke.py`` phase ``spatial`` (c) catch a wrong halo row?

    python3 tools/spatial_fault_check.py

On one card: config5's window of phase spatial (c) (stem 4, base 256,
``chip_smoke.config5_random_params``, fp32, TF32 off, 720x1280) unsharded,
then on two ranks of a 1 x 2 mesh that share the card in a gloo group,
three times: as is; with the rows that rank 1 receives from above zeroed
at the first halo exchange only; and at every exchange.  Prints one JSON
line: the card, each frame's and carry's share of values off saturation
(frames inside the clamp's (-0.5, 1.5), carries |c| < 0.999, |h| <
tanh(1)), and per run each array's largest difference from the unsharded
window and the share of its values more than (c)'s 1e-4 apart.
"""

from __future__ import annotations

import json
import os
import signal
import socket
import subprocess
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402

FAULTS = ("none", "first", "all")


def saturation(arrays: dict) -> dict:
    out = {}
    for k, v in arrays.items():
        if k.startswith("c_out"):
            off = (v > -0.5) & (v < 1.5)
        elif k.startswith("c_c"):
            off = np.abs(v) < 0.999
        else:
            off = np.abs(v) < np.tanh(1.0)
        out[k] = float(np.mean(off))
    return out


def cudnn_fp32(torch) -> None:
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def rank(r: int, port: int, top: str, fault: str) -> int:
    """One rank: (c)'s window on its band, with ``fault``; rank 0 writes
    the differences from the unsharded window in ``top``."""
    import torch
    import torch.distributed as dist

    from bin_tpu_torch.config import ParallelConfig
    from bin_tpu_torch.parallel import make_mesh
    from bin_tpu_torch.parallel.spatial import HaloExchange

    torch.cuda.set_device(0)
    cudnn_fp32(torch)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=2, rank=r)
    plan = make_mesh(ParallelConfig(data_axis_size=1, spatial_axis_size=2))
    exchange, calls = HaloExchange.exchange, [0]

    def faulty(self, x, up, down):
        above, below = exchange(self, x, up, down)
        calls[0] += 1
        if r == 1 and above is not None and (fault == "all"
                                             or calls[0] == 1):
            above = torch.zeros_like(above)
        return above, below

    if fault != "none":
        HaloExchange.exchange = faulty
    arrays = cs.config5_window(torch, plan, {})
    if r == 0:
        with np.load(os.path.join(top, "ref.npz")) as ref:
            diff = {k: np.abs(arrays[k] - ref[k]) for k in ref.files}
        with open(os.path.join(top, f"{fault}.json"), "w") as f:
            json.dump({k: {"max_abs_diff": float(d.max()),
                           "share_over_atol": float(np.mean(
                               d > cs.SPATIAL_FP32_ATOL))}
                       for k, d in diff.items()}, f)
    dist.destroy_process_group()
    return 0


def main() -> int:
    if sys.argv[1:2] == ["--rank"]:
        return rank(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
                    sys.argv[5])
    import torch

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    cudnn_fp32(torch)
    os.makedirs(cs.BUILD_DIR, exist_ok=True)
    result = {"card": card, "atol": cs.SPATIAL_FP32_ATOL}
    with tempfile.TemporaryDirectory(dir=cs.BUILD_DIR) as top:
        ref = cs.config5_window(torch, None, {})
        np.savez(os.path.join(top, "ref.npz"), **ref)
        result["off_saturation"] = saturation(ref)
        del ref
        torch.cuda.empty_cache()
        for fault in FAULTS:
            with socket.socket() as sock:
                sock.bind(("localhost", 0))
                port = sock.getsockname()[1]
            procs = [subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--rank", str(r),
                 str(port), top, fault], start_new_session=True)
                for r in range(2)]
            try:
                for p in procs:
                    p.wait(timeout=300)
            finally:
                for p in procs:
                    if p.poll() is None:
                        os.killpg(p.pid, signal.SIGKILL)
                        p.wait()
            if any(p.returncode for p in procs):
                raise SystemExit(f"fault {fault}: ranks exited "
                                 f"{[p.returncode for p in procs]}")
            with open(os.path.join(top, f"{fault}.json")) as f:
                result[fault] = json.load(f)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
