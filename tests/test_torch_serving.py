"""The port's HTTP serving daemon (``bin_tpu_torch/serving/server.py``) on
the CPU: the checks of ``tests/test_serving.py`` against the port.

Drives the real ThreadingHTTPServer over a socket: the frames delivered
over HTTP must equal, bit for bit, the frames a directly driven
``StreamingSession`` produces for the same weights and keys (u8, in the
server's mode), and agree with ``bin_tpu``'s session in the same mode to
the rounding of a u8 value."""

import http.client
import json
import threading
import time

import numpy as np
import pytest
import torch

from bin_tpu.config import ModelConfig as JaxModelConfig
from bin_tpu.evaluation.streaming import StreamingSession as JaxSession
from bin_tpu.registry import build_model as jax_build_model
from bin_tpu_torch import ModelConfig, build_model
from bin_tpu_torch.evaluation.streaming import StreamingSession
from bin_tpu_torch.serving.client import StreamClient
from bin_tpu_torch.serving.server import (FrameServer, make_http_server,
                                          serve_main)
from torch_params import one_torch_thread  # noqa: F401 (fixture)
from torch_params import random_flax_params

H = W = 32
NUM_KEYS = 7
RELEASE = "weights/prf_ema_r4.npz"
# bin_tpu's config2_pyramid at base 8 with one ResBlock (the model of
# tests/test_serving.py)
TINY = dict(name="pyramid", num_levels=2, cycle_level=True, base_features=8,
            num_res_blocks=1)


def _tiny_model():
    """The TINY model, random weights from a seed (``random_flax_params``'s
    default, so a second call gives the same tree)."""
    model = build_model(ModelConfig(**TINY), device="cpu")
    return model.load_params(random_flax_params(model.module))


def _frames(n=NUM_KEYS):
    rng = np.random.default_rng(3)
    return [rng.integers(0, 255, (H, W, 3), np.uint8) for _ in range(n)]


@pytest.fixture(scope="module")
def served():
    model = _tiny_model()
    server = FrameServer(model, max_streams=2)
    httpd = make_http_server(server, "127.0.0.1", 0)  # ephemeral port
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    yield model, httpd.server_address[1]
    httpd.shutdown()
    httpd.server_close()
    t.join(timeout=10)


def test_http_stream_matches_direct_session(served):
    """Through the supported client (StreamClient, TCP_NODELAY both ends)."""
    model, port = served
    frames = _frames()

    # reference: a direct session in the server's mode
    ref = StreamingSession(model, batch=1, height=H, width=W,
                           emit_u8=True, async_drain=True)
    for f in frames:
        ref.push(f[None])
    ref.flush()
    want = {t: f[0] for t, f in ref.drain()}
    ref.close()
    assert sorted(want) == list(range(1, 2 * NUM_KEYS - 2))

    with StreamClient("127.0.0.1", port, timeout=120) as client:
        sid = client.open(H, W)
        got = {}
        for f in frames:
            got.update({t: fr for t, fr in client.push(sid, f)})
            assert client.last_server_ms is not None
        got.update({t: fr for t, fr in client.close(sid)})

    assert sorted(got) == sorted(want)
    for t in want:
        assert got[t].dtype == np.uint8 and got[t].shape == (H, W, 3)
        np.testing.assert_array_equal(got[t], want[t])


def test_http_stream_matches_bin_tpu_session(served):
    """The server's mode against bin_tpu's: the same u8 keys through the
    port's HTTP server and through bin_tpu's ``StreamingSession(emit_u8=True,
    async_drain=True)`` on the same weights.  The frameworks sum in another
    order (their fp32 frames agree within 2e-5, test_torch_streaming.py), so
    a byte may round the other way where the value lies that close to a
    rounding boundary: never more than 1 apart, and on at most
    2 * 2e-5 * 255 ~ 1 % of the bytes."""
    model, port = served
    frames = _frames()
    theirs = JaxSession(jax_build_model(JaxModelConfig(**TINY)),
                        random_flax_params(model.module), batch=1, height=H,
                        width=W, emit_u8=True, async_drain=True)
    for f in frames:
        theirs.push(f[None])
    theirs.flush()
    want = {t: np.asarray(f[0]) for t, f in theirs.drain()}
    theirs.close()

    with StreamClient("127.0.0.1", port, timeout=120) as client:
        sid = client.open(H, W)
        got = {}
        for f in frames:
            got.update(client.push(sid, f))
        got.update(client.close(sid))

    assert sorted(got) == sorted(want) == list(range(1, 2 * NUM_KEYS - 2))
    diff = np.stack([got[t].astype(np.int16) - want[t].astype(np.int16)
                     for t in want])
    assert want[1].dtype == np.uint8
    assert np.abs(diff).max() <= 1
    assert np.count_nonzero(diff) <= 0.01 * diff.size


def test_stream_client_validates_and_errors(served):
    """Client-side shape gate + server errors surfaced as exceptions."""
    _, port = served
    with StreamClient("127.0.0.1", port, timeout=60) as client:
        assert client.health()["status"] == "ok"
        sid = client.open(H, W)
        with pytest.raises(ValueError, match="expected"):
            client.push(sid, np.zeros((H, W + 4, 3), np.uint8))
        with pytest.raises(ValueError, match="uint8"):
            client.push(sid, np.zeros((H, W, 3), np.float32))
        client.close(sid)
        with pytest.raises(RuntimeError, match="404"):
            client.push(sid, np.zeros((H, W, 3), np.uint8))  # closed stream
        with pytest.raises(RuntimeError, match="400"):
            client.open(30, 30)  # not divisible by the model factor
        # the connection survives drained error responses (keep-alive)
        sid = client.open(H, W)
        client.close(sid)


def test_http_errors_and_health(served):
    _, port = served
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)

    conn.request("GET", "/healthz")
    health = json.loads(conn.getresponse().read())
    assert health["status"] == "ok" and health["platform"] == "cpu"
    assert health["model"] == "pyramid" and health["max_streams"] == 2

    conn.request("GET", "/nowhere")
    resp = conn.getresponse()
    assert resp.status == 404
    resp.read()

    conn.request("POST", "/v1/streams/doesnotexist/frames", body=b"x")
    resp = conn.getresponse()
    assert resp.status == 404
    resp.read()

    conn.request("POST", "/v1/streams", body=b"not json")
    resp = conn.getresponse()
    assert resp.status == 400
    assert "JSON" in json.loads(resp.read())["error"]

    conn.request("POST", "/v1/streams",
                 body=json.dumps({"height": H, "width": W}))
    sid = json.loads(conn.getresponse().read())["id"]
    conn.request("GET", "/v1/streams")
    listed = json.loads(conn.getresponse().read())
    assert listed[sid] == {"height": H, "width": W, "keys_pushed": 0,
                           "frames_delivered": 0}
    conn.request("POST", f"/v1/streams/{sid}/frames", body=b"short")
    resp = conn.getresponse()
    assert resp.status == 400
    assert "expected" in json.loads(resp.read())["error"]

    # size not divisible by the model's downsampling factor
    conn.request("POST", "/v1/streams",
                 body=json.dumps({"height": 30, "width": 30}))
    resp = conn.getresponse()
    assert resp.status == 400
    resp.read()

    conn.request("POST", f"/v1/streams/{sid}/close")
    resp = conn.getresponse()
    assert resp.status == 200
    assert resp.getheader("X-Frame-Count") == "0"
    resp.read()
    conn.close()


def test_stream_limit(served):
    _, port = served
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    sids = []
    for _ in range(2):
        conn.request("POST", "/v1/streams",
                     body=json.dumps({"height": H, "width": W}))
        resp = conn.getresponse()
        assert resp.status == 201
        sids.append(json.loads(resp.read())["id"])
    conn.request("POST", "/v1/streams",
                 body=json.dumps({"height": H, "width": W}))
    resp = conn.getresponse()
    assert resp.status == 400
    assert "limit" in json.loads(resp.read())["error"]
    for sid in sids:
        conn.request("POST", f"/v1/streams/{sid}/close")
        conn.getresponse().read()
    conn.close()


def test_close_stops_fetch_thread_and_rejects_late_push(served):
    """Closing a stream stops its session's fetch thread (no per-stream
    thread leak), and a late push gets 404."""
    def _fetchers():
        return sum(t.name == "bin-tpu-torch-stream-fetch"
                   for t in threading.enumerate())

    _, port = served
    baseline = _fetchers()
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    conn.request("POST", "/v1/streams",
                 body=json.dumps({"height": H, "width": W}))
    sid = json.loads(conn.getresponse().read())["id"]
    assert _fetchers() == baseline + 1  # this stream's fetcher is alive
    conn.request("POST", f"/v1/streams/{sid}/close")
    conn.getresponse().read()
    for _ in range(100):
        if _fetchers() == baseline:
            break
        time.sleep(0.1)
    assert _fetchers() == baseline, "fetch thread leaked after close"
    conn.request("POST", f"/v1/streams/{sid}/frames",
                 body=np.zeros((H, W, 3), np.uint8).tobytes())
    resp = conn.getresponse()
    assert resp.status == 404
    resp.read()
    conn.close()


def test_serve_main_refuses_spatial(capsys):
    """Outside a launcher: --spatial N needs N ranks, and says how to
    start them (the sharded server itself: tests/test_torch_spatial.py)."""
    with pytest.raises(SystemExit) as exc:
        serve_main(["--weights", RELEASE, "--spatial", "2", "--device", "cpu"])
    assert exc.value.code == 2
    err = capsys.readouterr().err
    assert "--spatial" in err and "torchrun --nproc_per_node=2" in err


def test_serve_main_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        serve_main(["--weights", RELEASE])
