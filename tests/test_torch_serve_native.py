"""The port's native front (``lanczosnet_torch/native/servefront.cc``,
``serve_native.py``) and binary graph wire, on the CPU.

The wire codec gives the JAX package's bytes. The front is built with
g++ here (the tests skip, naming it, where g++ is missing) and serves a
small GCN on the CPU; every answer is held to the same ``Predictor``
called in-process. The four repairs of the fork are each tested: a
connection that takes over the descriptor of one that closed while its
request was in flight gets only its own answers; pipelined requests are
answered in order; a chunked POST gets 411 and the connection closes;
``close`` twice, with a request in flight, returns and frees the front.
A body that is not a JSON object gets a 400 and the front serves on, and
a front that does not build raises.
"""

import json
import shutil
import socket
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from lanczosnet_tpu.serve_native import encode_graphs_binary as jax_encode_graphs_binary
from lanczosnet_torch import serve_native
from lanczosnet_torch.data.qm8 import synthetic_qm8_graphs
from lanczosnet_torch.models import build_model
from lanczosnet_torch.serve import Predictor
from lanczosnet_torch.serve_http import ModelServer
from lanczosnet_torch.serve_native import (
    NativeFront,
    decode_graphs_binary,
    decode_predictions_binary,
    encode_graphs_binary,
    transcode,
)

N_MAX = 12
SLOW_S = 0.6


class SlowPredictor(Predictor):
    """A Predictor whose device program takes ``SLOW_S`` longer, so a
    request stays in flight while the test acts."""

    def _run(self, args):
        time.sleep(SLOW_S)
        return super()._run(args)


def tiny_predictor(cls=Predictor, batch_size=8):
    model = build_model({"name": "GCN", "num_atom": 8, "num_task": 16, "hidden_dim": [32],
                         "embed_dim": 32})
    model.init_weights(torch.Generator().manual_seed(0))
    return cls(model, model.state_dict(), n_max=N_MAX, batch_size=batch_size, num_task=16,
               device="cpu")


@pytest.fixture(scope="module")
def gxx():
    if shutil.which("g++") is None:
        pytest.skip("missing g++, which builds the native front")
    serve_native.build_front()


@pytest.fixture(scope="module")
def env(gxx):
    srv = ModelServer(max_delay_ms=2.0)
    srv.add_model("gcn", tiny_predictor())
    srv.add_model("slow", tiny_predictor(SlowPredictor), warmup=False)
    front = NativeFront(srv, port=0)
    yield srv, front, f"http://127.0.0.1:{front.port}"
    front.close()
    srv.close()


def graphs(n, seed=0):
    return [{k: v for k, v in g.items() if k != "label"}
            for g in synthetic_qm8_graphs(n, seed=seed, n_hi=10)]


def json_wire(gs):
    return json.dumps({"graphs": [{"atom_type": g["atom_type"].tolist(), "adj": g["adj"].tolist()}
                                  for g in gs]}).encode()


def post(url, data, timeout=60):
    req = urllib.request.Request(url, data=data, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def http_request(method, path, body=b"", extra=b""):
    return (b"%s %s HTTP/1.1\r\nHost: x\r\nContent-Length: %d\r\n%s\r\n"
            % (method, path, len(body), extra)) + body


def read_response(sock, buf=b""):
    """One HTTP response from ``sock`` → (status, body, bytes after it)."""
    while b"\r\n\r\n" not in buf:
        chunk = sock.recv(65536)
        if not chunk:
            raise ConnectionError(f"closed inside a response head: {buf!r}")
        buf += chunk
    head, rest = buf.split(b"\r\n\r\n", 1)
    lines = head.split(b"\r\n")
    length = int(next(h for h in lines if h.lower().startswith(b"content-length")).split(b":")[1])
    while len(rest) < length:
        chunk = sock.recv(65536)
        if not chunk:
            raise ConnectionError("closed inside a response body")
        rest += chunk
    return int(lines[0].split()[1]), rest[:length], rest[length:]


def nothing_more(sock, wait):
    """True if ``sock`` receives no byte within ``wait`` seconds."""
    sock.settimeout(wait)
    try:
        return sock.recv(65536) == b""
    except socket.timeout:
        return True


# ---- the wire (no front) ---------------------------------------------------


@pytest.mark.parametrize("feat", [False, True], ids=["no-features", "node-features"])
def test_encoder_gives_the_jax_encoders_bytes(feat):
    gs = graphs(5, seed=3)
    if feat:
        rng = np.random.default_rng(0)
        gs = [{**g, "node_feat": rng.standard_normal((len(g["atom_type"]), 3)).astype(np.float32)}
              for g in gs]
    gs.append({"atom_type": np.array([1, 2]), "adj": np.array([[0, 1], [1, 0]]),
               **({"node_feat": np.ones((2, 3), np.float32)} if feat else {})})
    body = encode_graphs_binary(gs)
    assert body == jax_encode_graphs_binary(gs)
    back = decode_graphs_binary(body)
    for g, b in zip(gs, back):
        np.testing.assert_array_equal(b["atom_type"], g["atom_type"])
        np.testing.assert_array_equal(b["adj"], np.asarray(g["adj"]).reshape(b["adj"].shape))
        if feat:
            np.testing.assert_array_equal(b["node_feat"], g["node_feat"])


def test_decoders_refuse_garbage():
    body = encode_graphs_binary(graphs(2))
    for bad in (b"XXXX" + body[4:], body + b"\0", b"LNG1" + (5000).to_bytes(4, "little")):
        with pytest.raises(ValueError):
            decode_graphs_binary(bad)
    with pytest.raises(ValueError, match="adj shape"):
        encode_graphs_binary([{"atom_type": np.ones(3), "adj": np.ones((1, 3, 2))}])
    with pytest.raises(ValueError):
        decode_predictions_binary(b"LNG1" + bytes(8))


def test_transcode_json_to_lng1_equals_the_encoder(gxx):
    gs = graphs(4, seed=7)
    assert transcode("json->lng1", json_wire(gs)) == encode_graphs_binary(gs)
    flat = {"graphs": [{"atom_type": [1, 2], "adj": [[0, 1], [1, 0]], "node_feat": None}]}
    assert transcode("json->lng1", json.dumps(flat).encode()) == encode_graphs_binary(
        [{"atom_type": [1, 2], "adj": [[0, 1], [1, 0]]}])
    # what the binary wire cannot carry is left to Python
    for body in (b"[]", b"null", b'{"graphs": []}', b"{}",
                 json.dumps({"graphs": [{"atom_type": [1], "adj": [[0.5]]}]}).encode(),
                 json.dumps({"graphs": [{"atom_type": [1], "adj": [[0]], "x": 1}]}).encode()):
        assert transcode("json->lng1", body) is None


def test_transcode_lnp1_to_json_round_trips_float32(gxx):
    preds = np.random.default_rng(1).standard_normal((3, 16)).astype(np.float32)
    body = b"LNP1" + np.array([3, 16], "<u4").tobytes() + preds.tobytes()
    back = np.asarray(json.loads(transcode("lnp1->json", body))["predictions"], np.float32)
    np.testing.assert_array_equal(back, preds)
    assert transcode("lnp1->json", body[:-4]) is None


# ---- the front -------------------------------------------------------------


def test_health_models_and_unknown_model(env):
    srv, _, base = env
    with urllib.request.urlopen(f"{base}/healthz", timeout=30) as r:
        assert json.loads(r.read()) == {"status": "ok"}
    with urllib.request.urlopen(f"{base}/v1/models", timeout=30) as r:
        assert json.loads(r.read()) == {"models": srv.models()}
    code, body = post(f"{base}/v1/models/nope:predict", b"{}")
    assert code == 404


def test_both_wires_answer_as_the_predictor(env):
    srv, front, base = env
    gs = graphs(10, seed=4)
    want = srv._predictors["gcn"].predict(gs)
    before = front.transcoded()
    code, body = post(f"{base}/v1/models/gcn:predict", encode_graphs_binary(gs))
    assert code == 200
    np.testing.assert_allclose(decode_predictions_binary(body), want, rtol=0, atol=1e-6)
    code, body = post(f"{base}/v1/models/gcn:predict", json_wire(gs))
    assert code == 200 and front.transcoded() == before + 1
    np.testing.assert_allclose(json.loads(body)["predictions"], want, rtol=0, atol=1e-6)
    # float edge weights: the Python JSON path, float32 wire
    half = [{**g, "adj": g["adj"] * 0.5} for g in gs]
    code, body = post(f"{base}/v1/models/gcn:predict", json.dumps(
        {"graphs": [{"atom_type": g["atom_type"].tolist(), "adj": g["adj"].tolist()}
                    for g in half]}).encode())
    assert code == 200 and front.transcoded() == before + 1
    np.testing.assert_allclose(json.loads(body)["predictions"],
                               srv._predictors["gcn"].predict(half), rtol=0, atol=1e-6)


@pytest.mark.parametrize("body", [b"[]", b"null", b"42", b'"x"', b'{"graphs": 1}', b"not json",
                                  b'{"graphs": []}', b"LNG1\x00\x00\x00\x00", b"LNG1\x01"],
                         ids=["list", "null", "number", "string", "graphs-number", "not-json",
                              "empty", "binary-empty", "binary-cut"])
def test_bad_bodies_are_400_and_the_front_serves_on(env, body):
    _, _, base = env
    code, payload = post(f"{base}/v1/models/gcn:predict", body)
    assert code == 400 and b"bad request" in payload
    code, _ = post(f"{base}/v1/models/gcn:predict", encode_graphs_binary(graphs(1)))
    assert code == 200


def test_fd_reuse_after_a_disconnect_delivers_no_stranger_answer(env):
    """A client closes while its request is in flight; the next
    connection (which takes the freed descriptor) gets only its own
    answers, not the stranger's when it completes."""
    srv, front, _ = env
    a = socket.create_connection(("127.0.0.1", front.port), timeout=30)
    a.sendall(http_request(b"POST", b"/v1/models/slow:predict", encode_graphs_binary(graphs(1))))
    time.sleep(0.15)  # parsed and in flight
    a.close()
    time.sleep(0.15)  # the front has closed the descriptor
    b = socket.create_connection(("127.0.0.1", front.port), timeout=30)
    try:
        b.sendall(http_request(b"GET", b"/healthz"))
        status, body, rest = read_response(b)
        assert status == 200 and json.loads(body) == {"status": "ok"} and rest == b""
        assert nothing_more(b, SLOW_S + 0.6)  # the stranger's answer was dropped
        gs = graphs(2, seed=8)
        b.settimeout(30)
        b.sendall(http_request(b"POST", b"/v1/models/gcn:predict", encode_graphs_binary(gs)))
        status, body, rest = read_response(b)
        assert status == 200 and rest == b""
        np.testing.assert_allclose(decode_predictions_binary(body),
                                   srv._predictors["gcn"].predict(gs), rtol=0, atol=1e-6)
    finally:
        b.close()


def test_pipelined_requests_are_answered_in_order(env):
    srv, front, _ = env
    gs = graphs(3, seed=6)
    s = socket.create_connection(("127.0.0.1", front.port), timeout=30)
    try:
        # a slow request, a fast one, an inline GET, a 400 and a 404 behind it
        s.sendall(http_request(b"POST", b"/v1/models/slow:predict", encode_graphs_binary(gs[:1]))
                  + http_request(b"POST", b"/v1/models/gcn:predict", encode_graphs_binary(gs[1:]))
                  + http_request(b"GET", b"/healthz")
                  + http_request(b"POST", b"/v1/models/gcn:predict", b"[]")
                  + http_request(b"POST", b"/v1/models/nope:predict", b"{}"))
        out, rest = [], b""
        for _ in range(5):
            status, body, rest = read_response(s, rest)
            out.append((status, body))
        assert [st for st, _ in out] == [200, 200, 200, 400, 404]
        want = srv._predictors["gcn"].predict(gs)
        np.testing.assert_allclose(decode_predictions_binary(out[0][1]), want[:1], atol=1e-6)
        np.testing.assert_allclose(decode_predictions_binary(out[1][1]), want[1:], atol=1e-6)
        assert json.loads(out[2][1]) == {"status": "ok"}
    finally:
        s.close()


def test_chunked_post_gets_411_and_the_connection_closes(env):
    _, front, _ = env
    s = socket.create_connection(("127.0.0.1", front.port), timeout=30)
    try:
        s.sendall(b"POST /v1/models/gcn:predict HTTP/1.1\r\nHost: x\r\n"
                  b"Transfer-Encoding: chunked\r\n\r\n5\r\nhello\r\n0\r\n\r\n")
        status, body, rest = read_response(s)
        assert status == 411 and b"Content-Length" in body and rest == b""
        assert nothing_more(s, 5.0)
    finally:
        s.close()


def test_close_twice_with_a_request_in_flight(gxx):
    srv = ModelServer(max_delay_ms=1.0)
    srv.add_model("slow", tiny_predictor(SlowPredictor), warmup=False)
    front = NativeFront(srv, port=0)
    s = socket.create_connection(("127.0.0.1", front.port), timeout=30)
    s.sendall(http_request(b"POST", b"/v1/models/slow:predict", encode_graphs_binary(graphs(1))))
    time.sleep(0.15)
    closers = [threading.Thread(target=front.close) for _ in range(2)]
    for t in closers:
        t.start()
    for t in closers:
        t.join(timeout=30)
    front.close()
    assert not any(t.is_alive() for t in closers) and not front._pull.is_alive()
    time.sleep(SLOW_S + 0.3)  # the answer arrives after the free, and is dropped
    assert front.served() == 0
    srv.close()
    s.close()


def test_a_front_that_does_not_build_raises(gxx, tmp_path, monkeypatch):
    bad = tmp_path / "servefront.cc"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(serve_native, "SOURCE", bad)
    monkeypatch.setattr(serve_native, "BUILD_DIR", tmp_path / "build")
    serve_native._lib.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
            NativeFront(ModelServer())
    finally:
        serve_native._lib.cache_clear()


def test_serve_main_with_native_fails_loudly_when_the_front_does_not_build(gxx, tmp_path,
                                                                          monkeypatch):
    """``python -m lanczosnet_torch.serve_http --native`` raises; it never
    falls back to the stdlib front."""
    from lanczosnet_torch import serve_http
    from tests.test_torch_export import GPNN, write_run

    run = write_run(tmp_path / "run", GPNN)
    bad = tmp_path / "servefront.cc"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(serve_native, "SOURCE", bad)
    monkeypatch.setattr(serve_native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(serve_http, "make_http_server",
                        lambda *a, **k: pytest.fail("fell back to the stdlib front"))
    serve_native._lib.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
            serve_http.main(["--model", f"gpnn={run}", "--native", "--device", "cpu",
                             "--port", "0", "--batch-size", "8"])
    finally:
        serve_native._lib.cache_clear()
