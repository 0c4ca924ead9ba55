"""`StreamClient`: the client half of the serving protocol (server.py), a
copy of ``bin_tpu/serving/client.py`` (numpy and the standard library).

Exists because the transport has one non-obvious requirement: **both sides
must disable Nagle's algorithm.** Each request/response is two writes
(headers, then body); with Nagle on, the second write waits for the peer's
delayed ACK of the first, and the per-key exchange collects multiple
~200 ms stalls. The server sets ``disable_nagle_algorithm``; a hand-rolled
``http.client`` caller would silently hit the slow path, so this wrapper is
the supported client.

Usage:
    client = StreamClient(host, port)
    sid = client.open(720, 1280)
    for key in keys:                       # (H, W, 3) uint8 RGB
        for t, frame in client.push(sid, key):
            deliver(t, frame)              # frame: (H, W, 3) uint8
    for t, frame in client.close(sid):
        deliver(t, frame)

Frames travel as raw uint8 RGB bytes (no base64/JSON tax; a 720p frame is
2.7 MB). One persistent HTTP/1.1 connection per client; methods are not
thread-safe: use one StreamClient per thread.
"""

from __future__ import annotations

import http.client
import json
import socket

import numpy as np

__all__ = ["StreamClient"]


class _NoDelayConnection(http.client.HTTPConnection):
    def connect(self):
        super().connect()
        self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)


class StreamClient:
    def __init__(self, host: str = "127.0.0.1", port: int = 8950,
                 timeout: float = 600.0):
        self._conn = _NoDelayConnection(host, port, timeout=timeout)
        self._sizes: dict[str, tuple[int, int]] = {}
        # server-side phase split of the LAST push response (X-Push-Ms /
        # X-Poll-Ms headers): (device-dispatch ms, ready-frame-fetch ms),
        # or None when the server predates the headers.  Lets callers
        # separate transport time from server time without a server log.
        self.last_server_ms: tuple[float, float] | None = None

    # -- plumbing -----------------------------------------------------------
    def _json(self, method: str, path: str, body: dict | None = None) -> dict:
        payload = json.dumps(body).encode() if body is not None else None
        self._conn.request(method, path, body=payload)
        resp = self._conn.getresponse()
        data = resp.read()  # always drain: keep-alive hygiene
        obj = json.loads(data) if data else {}
        if resp.status >= 400:
            raise RuntimeError(f"{method} {path} -> {resp.status}: "
                               f"{obj.get('error', data[:200])}")
        return obj

    def _frames(self, resp) -> list[tuple[int, np.ndarray]]:
        pm, lm = resp.getheader("X-Push-Ms"), resp.getheader("X-Poll-Ms")
        self.last_server_ms = ((float(pm), float(lm))
                               if pm is not None and lm is not None else None)
        n = int(resp.getheader("X-Frame-Count", 0))
        h = int(resp.getheader("X-Height"))
        w = int(resp.getheader("X-Width"))
        times = resp.getheader("X-Times", "")
        body = resp.read()
        if not n:
            return []
        frames = np.frombuffer(body, np.uint8).reshape(n, h, w, 3)
        ts = [int(x) for x in times.split(",")]
        return list(zip(ts, frames))

    # -- protocol -----------------------------------------------------------
    def health(self) -> dict:
        return self._json("GET", "/healthz")

    def open(self, height: int, width: int) -> str:
        sid = self._json("POST", "/v1/streams",
                         {"height": height, "width": width})["id"]
        self._sizes[sid] = (height, width)
        return sid

    def push(self, sid: str, frame: np.ndarray) -> list[tuple[int, np.ndarray]]:
        """Send one (H, W, 3) uint8 key frame; returns the (time, frame)
        outputs whose device→host transfer has completed (non-blocking on
        the server: compute for this key overlaps delivery of earlier ones).
        """
        h, w = self._sizes.get(sid, frame.shape[:2])
        if frame.shape != (h, w, 3) or frame.dtype != np.uint8:
            raise ValueError(f"expected ({h}, {w}, 3) uint8, got "
                             f"{frame.shape} {frame.dtype}")
        self._conn.request("POST", f"/v1/streams/{sid}/frames",
                           body=np.ascontiguousarray(frame).tobytes())
        resp = self._conn.getresponse()
        if resp.status != 200:
            err = resp.read()
            raise RuntimeError(f"push -> {resp.status}: {err[:200]}")
        return self._frames(resp)

    def close(self, sid: str) -> list[tuple[int, np.ndarray]]:
        """Flush + drain the stream; returns all remaining output frames."""
        self._conn.request("POST", f"/v1/streams/{sid}/close")
        resp = self._conn.getresponse()
        if resp.status != 200:
            err = resp.read()
            raise RuntimeError(f"close -> {resp.status}: {err[:200]}")
        self._sizes.pop(sid, None)
        return self._frames(resp)

    def disconnect(self) -> None:
        self._conn.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.disconnect()
