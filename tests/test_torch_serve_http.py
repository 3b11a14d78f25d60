"""The port's ``ModelServer`` and stdlib HTTP front against the JAX
package's, on the CPU.

Both servers hold the same flax parameters of two narrow models (a
LanczosNet and a GCN) and the same label stats, and answer the same JSON
requests over HTTP; the answers agree to 1e-4 (float32; the Ritz pairs
come from two eigensolvers, whose reconstructions the model consumes).
The routes, the 404s and the 400s (a body that is not a JSON object
among them) and the coalescing of concurrent clients are checked on the
port's front.
"""

import json
import threading
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest

from lanczosnet_tpu.data.dataset import LabelStats as JaxLabelStats
from lanczosnet_tpu.models import build_model as jax_build_model
from lanczosnet_tpu.serve import Predictor as JaxPredictor
from lanczosnet_tpu.serve_http import ModelServer as JaxModelServer
from lanczosnet_tpu.serve_http import make_http_server as jax_make_http_server
from lanczosnet_torch.data.dataset import LabelStats
from lanczosnet_torch.data.qm8 import synthetic_qm8_graphs
from lanczosnet_torch.models import build_model
from lanczosnet_torch.serve import Predictor
from lanczosnet_torch.serve_http import (
    ModelServer,
    decode_request,
    make_http_server,
    serve_forever_in_thread,
)
from lanczosnet_torch.weights import state_dict_from_flax
from tests.test_torch_dense_models import batch_for, flax_params, jax_batch, model_config
from tests.test_torch_models import NARROW, model_cfg

N_MAX, BATCH = 16, 8


def _models():
    """(name, model config) of the two served models."""
    gcn, _ = model_config("GCN", "narrow")
    return [("lnet", model_cfg(NARROW)), ("gcn", gcn)]


@pytest.fixture(scope="module")
def fronts():
    """(port ModelServer, port base URL, JAX base URL)."""
    labels = np.stack([g["label"] for g in synthetic_qm8_graphs(64, seed=9, n_hi=N_MAX)])
    fit = LabelStats.fit(labels)
    port, jax_srv = ModelServer(max_delay_ms=10.0), JaxModelServer(max_delay_ms=10.0)
    for i, (name, cfg) in enumerate(_models()):
        b = batch_for(cfg, "sym", 2, N_MAX)
        model = jax_build_model(cfg)
        params = flax_params(model, jax_batch(b), seed=i)
        k = int(cfg.get("num_eig_vec", 0)) if cfg["name"] == "LanczosNet" else 0
        common = dict(n_max=N_MAX, batch_size=BATCH, num_eig_vec=k, num_task=16)
        jax_srv.add_model(name, JaxPredictor(
            model, jax.tree.map(np.asarray, params),
            stats=JaxLabelStats(mean=fit.mean, std=fit.std), **common))
        port.add_model(name, Predictor(
            build_model(cfg), state_dict_from_flax(cfg["name"], params), stats=fit,
            device="cpu", **common))
    httpd, jax_httpd = make_http_server(port), jax_make_http_server(jax_srv)
    serve_forever_in_thread(httpd)
    serve_forever_in_thread(jax_httpd)
    yield port, "http://%s:%d" % httpd.server_address, "http://%s:%d" % jax_httpd.server_address
    for h in (httpd, jax_httpd):
        h.shutdown()
        h.server_close()
    port.close()
    jax_srv.close()


def _request(url, body=None):
    req = urllib.request.Request(url, data=body, method="POST" if body is not None else "GET",
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _wire(n, seed, scale=1.0):
    graphs = synthetic_qm8_graphs(n, seed=seed, n_hi=N_MAX)
    return {"graphs": [{"atom_type": g["atom_type"].tolist(), "adj": (g["adj"] * scale).tolist()}
                       for g in graphs]}


@pytest.mark.parametrize("name", ["lnet", "gcn"])
@pytest.mark.parametrize("scale", [1.0, 0.5], ids=["compact-wire", "float32-wire"])
def test_port_front_answers_as_the_jax_front(fronts, name, scale):
    _, base, jax_base = fronts
    body = json.dumps(_wire(11, seed=5, scale=scale)).encode()
    code, got = _request(f"{base}/v1/models/{name}:predict", body)
    jcode, want = _request(f"{jax_base}/v1/models/{name}:predict", body)
    assert code == jcode == 200
    got, want = np.asarray(got["predictions"]), np.asarray(want["predictions"])
    assert got.shape == want.shape == (11, 16)
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_health_models_and_stats(fronts):
    port, base, _ = fronts
    assert _request(f"{base}/healthz") == (200, {"status": "ok"})
    code, body = _request(f"{base}/v1/models")
    assert code == 200 and body["models"] == port.models()
    assert [m["name"] for m in body["models"]] == ["gcn", "lnet"]
    assert body["models"][0] == {"name": "gcn", "n_max": N_MAX, "batch_size": BATCH, "num_task": 16}
    _request(f"{base}/v1/models/gcn:predict", json.dumps(_wire(2, seed=1)).encode())
    code, stats = _request(f"{base}/v1/models/gcn/stats")
    assert code == 200 and stats["count"] >= 2 and stats["p95_ms"] >= stats["p50_ms"] > 0


@pytest.mark.parametrize("path,body", [
    ("/v1/models/nope/stats", None), ("/v1/nothing", None),
    ("/v1/models/nope:predict", b"{}"), ("/v1/models/gcn:explain", b"{}"),
], ids=["stats-unknown-model", "get-unknown-route", "predict-unknown-model", "post-unknown-route"])
def test_unknown_routes_and_models_are_404(fronts, path, body):
    _, base, _ = fronts
    code, payload = _request(base + path, body)
    assert code == 404 and "error" in payload


@pytest.mark.parametrize("body,says", [
    (b"[1, 2]", "JSON object"), (b"null", "JSON object"), (b"42", "JSON object"),
    (b'"graphs"', "JSON object"), (b'{"graphs": {"atom_type": [1]}}', "must be a list"),
    (b'{"graphs": 3}', "must be a list"), (b'{"graphs": []}', "empty graphs"), (b"{}", "empty"),
    (b"not json", "bad request"), (b'{"graphs": [[1, 2]]}', "JSON object"),
    (b'{"graphs": [{"adj": [[0]]}]}', "atom_type"),
    (b'{"graphs": [{"atom_type": [1, 2], "adj": "x"}]}', "bad request"),
], ids=["list", "null", "number", "string", "graphs-object", "graphs-number", "graphs-empty",
        "no-graphs", "not-json", "graph-not-object", "graph-without-atoms", "adj-not-numbers"])
def test_bad_bodies_are_400_naming_the_problem(fronts, body, says):
    _, base, _ = fronts
    code, payload = _request(f"{base}/v1/models/gcn:predict", body)
    assert code == 400 and says in payload["error"]
    # and the front serves on
    assert _request(f"{base}/v1/models/gcn:predict", json.dumps(_wire(1, seed=2)).encode())[0] == 200


def test_a_graph_larger_than_n_max_is_the_models_500(fronts):
    _, base, _ = fronts
    big = synthetic_qm8_graphs(1, seed=0, n_lo=N_MAX + 2, n_hi=N_MAX + 2)[0]
    body = json.dumps({"graphs": [{"atom_type": big["atom_type"].tolist(),
                                   "adj": big["adj"].tolist()}]}).encode()
    code, payload = _request(f"{base}/v1/models/gcn:predict", body)
    assert code == 500 and "n_max" in payload["error"]


def test_decode_request_takes_flat_adjacency_and_node_features():
    (g,) = decode_request(json.dumps({"graphs": [{
        "atom_type": [1, 2], "adj": [[0, 1], [1, 0]], "node_feat": [[0.5], [1.5]]}]}).encode())
    assert g["adj"].shape == (1, 2, 2) and g["adj"].dtype == np.float32
    assert g["atom_type"].dtype == np.int32 and g["node_feat"].shape == (2, 1)


def test_concurrent_clients_coalesce_into_batches(fronts):
    port, base, _ = fronts
    wire = _wire(16, seed=11)
    single = [json.dumps({"graphs": [g]}).encode() for g in wire["graphs"]]
    results, errors = [None] * 16, []
    before = port.stats("lnet").get("batches", 0)

    def client(i):
        try:
            code, body = _request(f"{base}/v1/models/lnet:predict", single[i])
            assert code == 200
            results[i] = body["predictions"][0]
        except Exception as exc:  # collected, asserted below
            errors.append(exc)

    threads = [threading.Thread(target=client, args=(i,)) for i in range(16)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errors and not any(t.is_alive() for t in threads)
    stats = port.stats("lnet")
    assert stats["batches"] - before < 16  # some requests shared a device batch
    want = port.predict("lnet", decode_request(json.dumps(wire).encode()))
    np.testing.assert_allclose(np.asarray(results), want, rtol=0, atol=1e-6)
