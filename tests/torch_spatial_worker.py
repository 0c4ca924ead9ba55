"""One rank of the port's height-sharded CPU runs
(``tests/test_torch_spatial.py``).

``run_rank`` joins a gloo group of 4 on ``tcp://localhost:<port>`` as a
data 2 x spatial 2 mesh and runs: a ``StreamingSession(plan=)`` of a small
config3_prf, the stem-4 window at height 720 (the module on the rank's
band and streams, the bands and the carries returned as they are), and
``evaluate_cli`` over the mesh.  Then ranks 0 and 1 join a new group of 2,
a 1 x 2 mesh, for ``FrameServer(spatial=2)`` (rank 0 takes the calls, rank
1 follows) and a direct session on its plan, one ``train`` step, and
last a sharded server over HTTP whose follower fails in a push.  Results
go on ``out`` as numpy.  The module imports no JAX, so a spawned rank
starts in seconds.
"""

from __future__ import annotations

import traceback

TINY = ["model.base_features=8", "model.num_res_blocks=1",
        "model.convlstm_features=16"]
EVAL = [*TINY, "data.eval_size=32,32", "data.eval_num_clips=6",
        "data.eval_num_keys=6", "model.dtype=float32"]
MESH = ["parallel.data_axis_size=2", "parallel.spatial_axis_size=2"]
TRAIN = [*TINY, "data.crop_size=32,32", "data.batch_size=4",
         "data.seq_len=5", "data.loader=grain", "log.log_interval_steps=1"]
STREAM = dict(batch=2, height=64, width=32, keys=6, seed=8)
WINDOW = dict(batch=2, keys=4, height=720, width=256, seed=0)
SERVER = dict(height=32, width=32, keys=7, seed=3)


def server_config():
    """``tests/test_serving.py``'s small config2_pyramid."""
    from bin_tpu_torch.config import get_config

    return get_config("config2_pyramid", ["model.base_features=8",
                                          "model.num_res_blocks=1"]).model


def stream_keys():
    import numpy as np

    s = STREAM
    return np.random.default_rng(s["seed"]).uniform(
        0, 1, (s["keys"], s["batch"], s["height"], s["width"], 3)).astype(
        np.float32)


def window_clip():
    import numpy as np

    s = WINDOW
    return np.random.default_rng(s["seed"]).uniform(
        0, 1, (s["batch"], s["keys"], s["height"], s["width"], 3)).astype(
        np.float32)


def server_frames():
    import numpy as np

    s = SERVER
    rng = np.random.default_rng(s["seed"])
    return [rng.integers(0, 255, (s["height"], s["width"], 3), np.uint8)
            for _ in range(s["keys"])]


def run_stream(model, plan) -> list:
    """Every (time, frame) of the stream keys through a buffered session."""
    from bin_tpu_torch.evaluation.streaming import StreamingSession

    s = STREAM
    sess = StreamingSession(model, batch=s["batch"], height=s["height"],
                            width=s["width"], buffer_drain=True, plan=plan)
    for key in stream_keys():
        sess.push(key)
    sess.flush()
    return sess.drain()


def run_window(model, plan) -> dict:
    """The module on this rank's streams and band of the window, with the
    consume-side clamp, as ``bin_tpu``'s ``apply_window``."""
    import torch

    s = WINDOW
    start, rows = model.band(s["height"])
    d = plan.data_index
    clip = torch.from_numpy(window_clip()[d:d + 1, :, start:start + rows])
    with torch.inference_mode():
        outs, states = model.module(clip, model.initial_state(
            1, s["height"], s["width"]), producer_clamp=False)
    return {"band": (start, rows),
            "outputs": [o.numpy() for o in outs],
            "states": [(h.numpy(), c.numpy()) for h, c in states]}


def serve(model, rank: int) -> dict:
    """Rank 0: a stream of the server frames through a sharded
    ``FrameServer``, rank 1 following; then both: the same frames through
    a direct session in the server's mode on the server's plan."""
    from bin_tpu_torch.evaluation.streaming import StreamingSession
    from bin_tpu_torch.serving.server import FrameServer

    s = SERVER
    server = FrameServer(model, spatial=2)
    got = None
    if rank:
        server.follow()
    else:
        sid = server.create_stream(s["height"], s["width"])
        got = []
        for frame in server_frames():
            got += server.push(sid, frame)[0]
        got += server.close(sid)
        server.stop()
    sess = StreamingSession(model, 1, s["height"], s["width"], emit_u8=True,
                            async_drain=True, plan=server.plan)
    try:
        for frame in server_frames():
            sess.push(frame[None])
        sess.flush()
        direct = [(t, f[0]) for t, f in sess.drain()]
    finally:
        sess.close()
    return {"server": got, "direct": direct}


def follower_fails(model, rank: int) -> dict:
    """``FrameServer(spatial=2)`` over HTTP whose follower fails in its
    first push: the follower's loop raises and its process ends; rank 0's
    client then gets HTTP 500 from the push whose collective meets the
    ended rank and from every later one, and /healthz says "down".  Every
    push's outcome ("ok" or the error) is returned.  Leaves the ranks out
    of step: the last case."""
    import threading
    import time

    from bin_tpu_torch.evaluation.streaming import StreamingSession
    from bin_tpu_torch.serving.client import StreamClient
    from bin_tpu_torch.serving.server import (FrameServer, ShardFailure,
                                              make_http_server)

    s = SERVER
    server = FrameServer(model, spatial=2)
    if rank:
        def push(self, keys):
            raise RuntimeError("the follower's push failed")

        StreamingSession.push = push
        try:
            server.follow()
        except ShardFailure as exc:
            return {"follower": str(exc)}
        return {"follower": None}
    httpd = make_http_server(server, "127.0.0.1", 0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    outcomes = []
    t0 = time.monotonic()
    try:
        with StreamClient("127.0.0.1", httpd.server_address[1],
                          timeout=60) as client:
            sid = client.open(s["height"], s["width"])
            for frame in server_frames():
                try:
                    client.push(sid, frame)
                    outcomes.append("ok")
                except RuntimeError as exc:
                    outcomes.append(str(exc))
            health = client.health()["status"]
    finally:
        server.stop()
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)
    return {"outcomes": outcomes, "health": health,
            "seconds": time.monotonic() - t0}


def run_rank(rank: int, ports: tuple[int, int], workdir: str, params: dict,
             out) -> None:
    try:
        import torch
        import torch.distributed as dist

        torch.set_num_threads(1)
        from bin_tpu_torch import build_model
        from bin_tpu_torch.config import ParallelConfig, get_config
        from bin_tpu_torch.evaluation.evaluator import evaluate_cli
        from bin_tpu_torch.parallel import make_mesh, maybe_initialize
        from bin_tpu_torch.training import trainer

        assert maybe_initialize("cpu", f"tcp://localhost:{ports[0]}", 4, rank)
        plan = make_mesh(ParallelConfig(data_axis_size=2,
                                        spatial_axis_size=2))
        result = {"rank": rank, "plan": (plan.num_data, plan.num_spatial,
                                         plan.data_index,
                                         plan.spatial_index)}
        small = get_config("config3_prf", TINY).model
        model = build_model(small, "cpu").load_params(params["stream"])
        result["stream"] = run_stream(model, plan)
        result["halo"] = (model.halo.exchanges, model.halo.bytes_sent)
        c5 = get_config("config5_v5e_streaming",
                        [*TINY, "model.dtype=float32"]).model
        model = build_model(c5, "cpu").load_params(params["window"])
        result["window"] = run_window(model.shard_height(plan), plan)
        result["eval"] = evaluate_cli(get_config("config3_prf",
                                                 [*EVAL, *MESH]),
                                      device="cpu", verbose=False)
        dist.destroy_process_group()
        if rank < 2:
            assert maybe_initialize("cpu", f"tcp://localhost:{ports[1]}", 2,
                                    rank)
            model = build_model(server_config(), "cpu").load_params(
                params["server"])
            result["server"] = serve(model, rank)
            _, state = trainer.train(get_config(
                "config3_prf", [*TRAIN, "parallel.spatial_axis_size=2",
                                "parallel.data_axis_size=-1"]),
                workdir, 1, device="cpu")
            result["train"] = {k: v.detach().numpy().copy() for k, v in
                               state.named(state.params).items()}
            result["down"] = follower_fails(model, rank)
        out.put(result)
    except BaseException:
        out.put({"rank": rank, "error": traceback.format_exc()})
    finally:
        from bin_tpu_torch.parallel.distributed import shutdown

        shutdown()
