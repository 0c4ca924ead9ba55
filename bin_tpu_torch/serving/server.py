"""`bin-tpu-serve` in the port: a streaming-inference daemon
(``bin_tpu/serving/server.py``).

An HTTP service wrapping ``bin_tpu_torch.evaluation.streaming.
StreamingSession``, one session per client stream, frames as raw uint8 RGB
bytes both ways (no base64/JSON payload tax: a 720p frame is 2.7 MB).

    python -m bin_tpu_torch.serving.server --weights weights/prf_ema_r4.npz \\
        [--set model.KEY=V] [--host H] [--port P] [--max-streams N] \\
        [--device cuda|cpu]
    torchrun --nproc_per_node=N -m bin_tpu_torch.serving.server \\
        --weights weights/prf_ema_r4.npz --spatial N

Design notes
- One StreamingSession(batch=1) per stream: sessions of one server share
  the model and its weights on the card.
- async_drain + emit_u8: finalized u8 emissions are copied to pinned host
  memory on a side CUDA stream and collected by a background thread, so
  the next key's compute overlaps the previous key's device->host copy.
- stdlib ThreadingHTTPServer: one OS thread per in-flight request; a
  per-stream lock serializes pushes within a stream, a registry lock
  guards create/close.  No extra dependencies.
- TCP_NODELAY on both ends (here and ``client.StreamClient``): the
  headers+body two-write pattern otherwise collects Nagle/delayed-ACK
  stalls every exchange.  Use StreamClient, not bare http.client.
- ``--spatial N`` (``FrameServer(spatial=N)``): each stream's frame height
  is sharded over N ranks, one card each (a 1 x N mesh; the sessions'
  ``plan``).  Rank 0 serves HTTP and broadcasts each create, push and
  close, in the order it runs them, to ranks 1..N-1, which run them in a
  follower loop (``FrameServer.follow``); those data-path calls take turns
  on rank 0, so every rank makes its collectives in one order.  A call
  that fails on any rank once it has gone out leaves the ranks out of
  step: that rank takes no further call (``ShardFailure``, HTTP 500), and
  a follower's loop raises, which ends its process and so fails rank 0's
  next collective with it.

Protocol (all frame bodies are raw uint8 RGB, H*W*3 bytes per frame):
  GET  /healthz                  -> JSON {status, platform, model, streams}
  POST /v1/streams               -> JSON {"height":H,"width":W} in,
                                   {"id": ...} out (201)
  POST /v1/streams/<id>/frames   -> body = ONE key frame; 200 response body =
                                   concatenated output frames ready so far,
                                   X-Times: comma-separated output times,
                                   X-Frame-Count / X-Height / X-Width set
  POST /v1/streams/<id>/close    -> flush + drain; body = remaining frames
                                   (headers as above); stream deleted
  GET  /v1/streams               -> JSON list of open streams

``platform`` in /healthz is the torch device type ("cuda" or "cpu").
"""

from __future__ import annotations

import argparse
import contextlib
import json
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch.distributed as dist

from bin_tpu_torch.evaluation.streaming import StreamingSession
from bin_tpu_torch.models.pyramid import bottleneck_factor
from bin_tpu_torch.registry import Model

__all__ = ["FrameServer", "ShardFailure", "make_http_server", "serve_main"]


class ShardFailure(RuntimeError):
    """A call of a sharded server failed on this rank after it had gone out
    to every rank: the ranks' collectives are out of step, and the server
    takes no further call."""


class _Stream:
    def __init__(self, session: StreamingSession, height: int, width: int):
        self.session = session
        self.height, self.width = height, width
        self.lock = threading.Lock()
        self.closed = False  # guarded by lock: a push that was blocked on a
        #                      concurrent close() must fail, not feed (and
        #                      lose frames into) the already-drained session
        self.keys_pushed = 0
        self.frames_delivered = 0


class FrameServer:
    """Model + stream registry; the HTTP handler delegates here, so it is
    directly testable and reusable behind other fronts.

    ``spatial`` > 1: every stream's frame height is sharded over that many
    ranks of the process group, which must hold exactly that many
    (``make_mesh`` of a 1 x ``spatial`` mesh; ``model`` is bound to it).
    Rank 0 takes the calls; the other ranks run ``follow``."""

    def __init__(self, model: Model, max_streams: int = 4, spatial: int = 1):
        self.model = model
        self.max_streams = max_streams
        self.plan = None
        self._control = None
        # one data-path call at a time where the ranks must agree on order
        self._turn = contextlib.nullcontext()
        if spatial > 1:
            from bin_tpu_torch.config import ParallelConfig
            from bin_tpu_torch.parallel import make_mesh

            self.plan = make_mesh(ParallelConfig(data_axis_size=1,
                                                 spatial_axis_size=spatial))
            model.shard_height(self.plan)
            # the calls travel pickled, through host memory
            self._control = dist.new_group(backend="gloo")
            self._turn = threading.Lock()
        self._streams: dict[str, _Stream | None] = {}
        self._lock = threading.Lock()
        self._down: str | None = None  # why a sharded server stopped

    @contextlib.contextmanager
    def _in_step(self):
        """Around a call that every rank runs (its broadcast included): a
        failure there leaves a sharded server's ranks out of step, so it
        raises ``ShardFailure`` now and at every later call."""
        if self._down is not None:
            raise ShardFailure(f"the sharded server is down: {self._down}")
        try:
            yield
        except Exception as exc:
            if self.plan is None:
                raise
            self._down = f"rank {self.plan.rank}: {type(exc).__name__}: {exc}"
            raise ShardFailure(self._down) from exc

    def _tell(self, *call) -> None:
        """Rank 0: hand one call to the follower ranks."""
        if self._control is not None and self.plan.is_main:
            dist.broadcast_object_list([call], src=0, group=self._control)

    def follow(self) -> None:
        """Ranks 1..N-1 of a sharded server: run rank 0's calls, in its
        order, until ``stop``.  A call that fails here raises
        ``ShardFailure`` and ends the loop; the rank's process is then to
        end, which fails rank 0's next collective with it (rank 0's call
        raises ``ShardFailure`` in turn)."""
        while True:
            box = [None]
            dist.broadcast_object_list(box, src=0, group=self._control)
            op, *args = box[0]
            if op == "stop":
                return
            with self._in_step():
                if op == "open":
                    self._open(*args)
                elif op == "push":
                    stream = self._get(args[0])
                    stream.session.push(args[1][None])
                    stream.session.poll()
                else:
                    self._retire(self._get(args[0]), args[0])

    def stop(self) -> None:
        """Rank 0 of a sharded server: end the followers' loops (those of
        a server that is down have ended or wait on a rank that has)."""
        with self._turn:
            if self._down is None:
                self._tell("stop")

    # -- registry ---------------------------------------------------------
    def create_stream(self, height: int, width: int) -> str:
        f = bottleneck_factor(self.model.cfg)
        if height % f or width % f:
            raise ValueError(f"frame size {height}x{width} must be divisible "
                             f"by {f} for this model")
        self.model.bands(height)  # a height the spatial axis cannot cut
        with self._turn:
            with self._lock:
                if len(self._streams) >= self.max_streams:
                    raise RuntimeError(
                        f"stream limit reached ({self.max_streams})")
                sid = uuid.uuid4().hex[:12]
                # placeholder first so the limit holds while we build the
                # session
                self._streams[sid] = None
            try:
                with self._in_step():
                    self._tell("open", sid, height, width)
                    self._open(sid, height, width)
            except BaseException:
                with self._lock:
                    self._streams.pop(sid, None)
                raise
        return sid

    def _open(self, sid: str, height: int, width: int) -> None:
        session = StreamingSession(self.model, batch=1, height=height,
                                   width=width, emit_u8=True,
                                   async_drain=True, plan=self.plan)
        with self._lock:
            self._streams[sid] = _Stream(session, height, width)

    def _get(self, sid: str) -> _Stream:
        with self._lock:
            stream = self._streams.get(sid)
        if stream is None:
            raise KeyError(sid)
        return stream

    # -- data path --------------------------------------------------------
    def push(self, sid: str, frame: np.ndarray) -> tuple[
            list[tuple[int, np.ndarray]], tuple[float, float]]:
        """Feed one (H, W, 3) u8 key frame; returns (ready, timing):
        ready = (time, (H, W, 3) u8) output frames whose copy to the host
        has completed (non-blocking); timing = this push's (push_ms,
        poll_ms), returned rather than stored so that two concurrent pushes
        on one stream cannot swap each other's response headers."""
        stream = self._get(sid)
        if frame.shape != (stream.height, stream.width, 3):
            raise ValueError(f"frame {frame.shape}, the stream takes "
                             f"({stream.height}, {stream.width}, 3)")
        with self._turn, stream.lock:
            if stream.closed:
                raise KeyError(sid)
            with self._in_step():
                self._tell("push", sid, frame)
                t0 = time.monotonic()
                stream.session.push(frame[None])
                t1 = time.monotonic()
                stream.keys_pushed += 1
                ready = stream.session.poll()
                t2 = time.monotonic()
            stream.frames_delivered += len(ready)
        return ([(t, f[0]) for t, f in ready],
                (1e3 * (t1 - t0), 1e3 * (t2 - t1)))

    def close(self, sid: str) -> list[tuple[int, np.ndarray]]:
        """Flush trailing emissions, wait for the copies in flight, stop the
        session's fetch thread, delete."""
        stream = self._get(sid)
        with self._turn, stream.lock:
            if stream.closed:
                raise KeyError(sid)
            with self._in_step():
                self._tell("close", sid)
                remaining = self._retire(stream, sid)
        return [(t, f[0]) for t, f in remaining]

    def _retire(self, stream: _Stream, sid: str) -> list:
        stream.closed = True
        try:
            stream.session.flush()
            remaining = stream.session.drain()
        finally:
            stream.session.close()
        with self._lock:
            self._streams.pop(sid, None)
        return remaining

    def stats(self) -> dict:
        with self._lock:
            streams = {sid: {"height": s.height, "width": s.width,
                             "keys_pushed": s.keys_pushed,
                             "frames_delivered": s.frames_delivered}
                       for sid, s in self._streams.items() if s is not None}
        return {"status": "ok" if self._down is None else "down",
                "model": self.model.cfg.name,
                "window_size": self.model.cfg.window_size,
                "max_streams": self.max_streams, "streams": streams}


def _make_handler(server: FrameServer):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"
        # Every response is two writes (headers, body); with Nagle on, the
        # body write stalls on the client's delayed ACK of the header packet.
        # Clients must do the same (client.StreamClient does).
        disable_nagle_algorithm = True

        def log_message(self, fmt, *args):  # quiet by default
            pass

        # -- helpers ------------------------------------------------------
        def _json(self, code: int, obj) -> None:
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _frames(self, frames: list[tuple[int, np.ndarray]],
                    height: int, width: int,
                    timing: tuple[float, float] | None = None) -> None:
            body = b"".join(np.ascontiguousarray(f).tobytes()
                            for _, f in frames)
            self.send_response(200)
            self.send_header("Content-Type", "application/octet-stream")
            self.send_header("Content-Length", str(len(body)))
            self.send_header("X-Frame-Count", str(len(frames)))
            self.send_header("X-Times", ",".join(str(t) for t, _ in frames))
            self.send_header("X-Height", str(height))
            self.send_header("X-Width", str(width))
            if timing is not None:
                # this push's server-side split: compute dispatch (push) and
                # ready-frame collection (poll), apart from the transport
                self.send_header("X-Push-Ms", f"{timing[0]:.1f}")
                self.send_header("X-Poll-Ms", f"{timing[1]:.1f}")
            self.end_headers()
            self.wfile.write(body)

        def _read_body(self) -> bytes:
            n = int(self.headers.get("Content-Length", 0))
            return self.rfile.read(n)

        # -- routes -------------------------------------------------------
        def do_GET(self):
            if self.path == "/healthz":
                info = server.stats()
                info["platform"] = server.model.device.type
                return self._json(200, info)
            if self.path == "/v1/streams":
                return self._json(200, server.stats()["streams"])
            return self._json(404, {"error": f"no route {self.path}"})

        def do_POST(self):
            # drain the request body first: replying without consuming it
            # would corrupt the keep-alive connection for the next request
            body = self._read_body()
            try:
                return self._post(body)
            except KeyError as exc:
                return self._json(404, {"error": f"no stream {exc}"})
            except ShardFailure as exc:
                return self._json(500, {"error": str(exc)})
            except (ValueError, RuntimeError) as exc:
                return self._json(400, {"error": str(exc)})

        def _post(self, body: bytes):
            parts = [p for p in self.path.split("/") if p]
            if parts == ["v1", "streams"]:
                try:
                    spec = json.loads(body or b"{}")
                except json.JSONDecodeError as exc:
                    raise ValueError(f"body is not JSON: {exc}")
                if (not isinstance(spec, dict) or "height" not in spec
                        or "width" not in spec):
                    raise ValueError(
                        'body must be {"height": H, "width": W}')
                sid = server.create_stream(int(spec["height"]),
                                           int(spec["width"]))
                return self._json(201, {"id": sid})
            if len(parts) == 4 and parts[:2] == ["v1", "streams"]:
                sid, verb = parts[2], parts[3]
                if verb == "frames":
                    stream = server._get(sid)  # shape check needs H, W
                    want = stream.height * stream.width * 3
                    if len(body) != want:
                        raise ValueError(
                            f"frame body is {len(body)} bytes, expected "
                            f"{want} (raw u8 RGB "
                            f"{stream.height}x{stream.width}x3)")
                    frame = np.frombuffer(body, np.uint8).reshape(
                        stream.height, stream.width, 3)
                    ready, timing = server.push(sid, frame)
                    return self._frames(
                        ready, stream.height, stream.width, timing=timing)
                if verb == "close":
                    stream = server._get(sid)
                    return self._frames(server.close(sid),
                                        stream.height, stream.width)
            return self._json(404, {"error": f"no route {self.path}"})

    return Handler


def make_http_server(server: FrameServer, host: str = "127.0.0.1",
                     port: int = 8950) -> ThreadingHTTPServer:
    return ThreadingHTTPServer((host, port), _make_handler(server))


def serve_main(argv: list[str] | None = None) -> None:
    p = argparse.ArgumentParser(
        description="Serve streaming joint deblur + 2x-interp over HTTP.")
    p.add_argument("--weights", required=True, help=".npz release file")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8950)
    p.add_argument("--max-streams", type=int, default=4)
    p.add_argument("--spatial", type=int, default=1,
                   help="shard each stream's frame height over N ranks, one "
                        "card each: start N processes with torchrun "
                        "--nproc_per_node=N")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu (the plain versions)")
    p.add_argument("--set", dest="overrides", action="append", default=[],
                   metavar="model.KEY=VALUE",
                   help="deployment override on top of the card's stored "
                        "model config (e.g. model.conv_int8=true or "
                        "model.dtype=bfloat16). Repeatable.")
    args = p.parse_args(argv)

    from bin_tpu_torch.benchmark import check_sidecar
    from bin_tpu_torch.config import apply_model_overrides
    from bin_tpu_torch.parallel import maybe_initialize
    from bin_tpu_torch.parallel.distributed import (local_device, shutdown,
                                                    world)
    from bin_tpu_torch.registry import build_model
    from bin_tpu_torch.weights import card_config, load_weights

    if args.spatial > 1:
        maybe_initialize(args.device)
        if world()[1] != args.spatial:
            p.error(f"--spatial {args.spatial} shards over {args.spatial} "
                    f"ranks and this run has {world()[1]}: start it with "
                    f"torchrun --nproc_per_node={args.spatial} -m "
                    "bin_tpu_torch.serving.server --weights ... --spatial "
                    f"{args.spatial}")

    model_cfg, _ = card_config(args.weights)
    if args.overrides:
        model_cfg = apply_model_overrides(model_cfg, args.overrides)
        print(f"bin-tpu-serve: deployment overrides {args.overrides}")
    check_sidecar(model_cfg, args.weights)
    # raises without a card
    model = build_model(model_cfg, local_device(args.device))
    model.load_params(load_weights(args.weights)[0])
    server = FrameServer(model, max_streams=args.max_streams,
                         spatial=args.spatial)
    if server.plan is not None and not server.plan.is_main:
        try:
            server.follow()
        finally:
            shutdown()
        return
    httpd = make_http_server(server, args.host, args.port)
    print(f"bin-tpu-serve: model={model_cfg.name} "
          f"window={model_cfg.window_size} on {model.device} at "
          f"http://{args.host}:{args.port} (max {args.max_streams} streams)",
          flush=True)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
        if server.plan is not None:
            server.stop()
            shutdown()


if __name__ == "__main__":
    serve_main()
