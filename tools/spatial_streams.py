#!/usr/bin/env python3
"""A height-sharded stream against the unsharded one, one card a rank.

    torchrun --nproc_per_node=N tools/spatial_streams.py [--keys 20]
    torchrun --nproc_per_node=2 tools/spatial_streams.py --device cpu \\
        --height 64 --width 64 --set model.base_features=8 \\
        --set model.num_res_blocks=1 --set model.convlstm_features=16

The release weights in the serving mode (``benchmark.SERVING_MODE`` and
its overrides; ``--set`` on top), on a 1 x N mesh: every rank streams the
same u8 keys through ``StreamingSession(plan=)`` in the server's mode
(``emit_u8``, ``async_drain``), free-running, then synchronised after
every push; rank 0 first streams them unsharded on its own card while the
others wait.  Prints, from rank 0, one JSON line: the group's backend,
each rank's band, ms a key sharded (free-running and per key) and
unsharded, the halo exchanges and bytes a key, and the u8 frames against
the unsharded ones (the largest difference and the values that differ).
On CUDA the group is NCCL and each rank takes ``cuda:LOCAL_RANK``; with
``--device cpu`` it is gloo.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def stream(sess, keys, sync=None) -> tuple[dict, float, list]:
    """{time: u8 frame} of ``keys`` through ``sess``; seconds from the
    first push to the last frame; each push's ms when ``sync`` is given."""
    got, per_key = {}, []
    t0 = time.perf_counter()
    for key in keys:
        t = time.perf_counter()
        sess.push(key[None])
        if sync:
            sync()
            per_key.append((time.perf_counter() - t) * 1e3)
        got.update((tm, f[0]) for tm, f in sess.poll())
    sess.flush()
    got.update((tm, f[0]) for tm, f in sess.drain())
    return got, time.perf_counter() - t0, per_key


def main() -> int:
    import numpy as np
    import torch
    import torch.distributed as dist

    from bin_tpu_torch.benchmark import (SERVING_MODE, WEIGHTS,
                                         serving_overrides)
    from bin_tpu_torch.config import ParallelConfig, apply_model_overrides
    from bin_tpu_torch.evaluation.streaming import StreamingSession
    from bin_tpu_torch.parallel import make_mesh, maybe_initialize
    from bin_tpu_torch.parallel.distributed import local_device, shutdown
    from bin_tpu_torch.registry import build_model
    from bin_tpu_torch.weights import load_weights

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--keys", type=int, default=20)
    p.add_argument("--height", type=int, default=720)
    p.add_argument("--width", type=int, default=1280)
    p.add_argument("--device", default="cuda")
    p.add_argument("--set", dest="overrides", action="append", default=[])
    args = p.parse_args()
    if not maybe_initialize(args.device):
        p.error("start it with torchrun --nproc_per_node=N")
    device = local_device(args.device)
    rank, world = dist.get_rank(), dist.get_world_size()
    params, cfg, _ = load_weights(WEIGHTS)
    cfg = apply_model_overrides(cfg, [*SERVING_MODE,
                                      *serving_overrides(WEIGHTS),
                                      *args.overrides])
    if args.overrides:  # another width: random weights of that width
        model = build_model(cfg, device)
        params = model.init(0)
    keys = np.random.default_rng(6).integers(
        0, 256, (args.keys, args.height, args.width, 3), dtype=np.uint8)
    sync = torch.cuda.synchronize if device.type == "cuda" else None
    out = {"backend": dist.get_backend(), "world": world,
           "device": (torch.cuda.get_device_name(device)
                      if device.type == "cuda" else "cpu"),
           "keys": args.keys, "size": [args.height, args.width]}
    if rank == 0:
        plain = build_model(cfg, device).load_params(params)
        sess = StreamingSession(plain, 1, args.height, args.width,
                                emit_u8=True, async_drain=True)
        stream(sess, keys[:plain.cfg.window_size])  # warm-up
        sess.close()
        sess = StreamingSession(plain, 1, args.height, args.width,
                                emit_u8=True, async_drain=True)
        want, sec, _ = stream(sess, keys)
        sess.close()
        out["unsharded_ms_per_key"] = sec * 1e3 / args.keys
        del plain, sess
    dist.barrier()
    plan = make_mesh(ParallelConfig(data_axis_size=1,
                                    spatial_axis_size=world))
    model = build_model(cfg, device).load_params(params).shard_height(plan)
    rows = {}
    for run in ("warm-up", "free", "synced"):
        sess = StreamingSession(model, 1, args.height, args.width,
                                emit_u8=True, async_drain=True, plan=plan)
        model.halo.reset_counts()
        n = model.cfg.window_size if run == "warm-up" else args.keys
        got, sec, per_key = stream(sess, keys[:n],
                                   sync if run == "synced" else None)
        sess.close()
        windows = n - model.cfg.window_size + 1
        rows[run] = {"ms_per_key": sec * 1e3 / n,
                     "halo_exchanges_per_key": model.halo.exchanges / windows,
                     "halo_bytes_per_key": model.halo.bytes_sent / windows}
        if per_key:
            rows[run]["push_ms_median"] = statistics.median(per_key)
    ranks = [None] * world
    dist.all_gather_object(ranks, {"rank": rank,
                                   "band": model.band(args.height),
                                   "free": rows["free"],
                                   "synced": rows["synced"]})
    if rank == 0:
        d = [np.abs(got[t].astype(np.int16) - want[t].astype(np.int16))
             for t in sorted(want)]
        out.update(ranks=ranks, frames=len(d),
                   same_times=sorted(got) == sorted(want),
                   max_abs_diff=int(max(x.max() for x in d)),
                   values_differing=int(sum(np.count_nonzero(x)
                                            for x in d)),
                   values=int(sum(x.size for x in d)))
        print(json.dumps(out), flush=True)
    shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
