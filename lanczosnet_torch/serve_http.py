"""Several models behind one HTTP front.

Counterpart of ``lanczosnet_tpu/serve_http.py``:

- ``ModelServer`` keeps named ``Predictor``s on their device, each behind
  its own ``MicroBatcher``, so concurrent clients of one model coalesce
  into one device program per batch. ``from_run_dirs`` takes a run the
  port trained (``checkpoints/<tag>.pt``), a run the JAX package trained
  (``checkpoints/<tag>.msgpack``) or an artifact directory that
  ``export.py`` wrote.
- ``make_http_server`` is a stdlib ``ThreadingHTTPServer`` JSON API in
  front of a ``ModelServer`` (HTTP/1.1 keep-alive, a 256-deep accept
  queue):

      GET  /healthz                     → {"status": "ok"}
      GET  /v1/models                   → model list and shapes
      GET  /v1/models/<name>/stats      → p50/p95 latency of that model
      POST /v1/models/<name>:predict    → {"predictions": [[...], ...]}
        body: {"graphs": [{"atom_type": [...], "adj": [[[...]]],
                           "node_feat": [[...]]?}, ...]}

  A body that is not a JSON object, whose ``graphs`` is not a list, or
  whose graphs do not decode gets a 400 naming the problem; a model
  error a 500.

    python -m lanczosnet_torch.serve_http --model lnet=exp/... [--native]

``--native`` serves through the C++ epoll front of ``serve_native.py``;
if that front cannot be built or loaded the command fails, it never
falls back to the stdlib front. Models run on the card unless ``--device
cpu`` asks for the CPU.
"""

from __future__ import annotations

import json
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from typing import Mapping

import numpy as np
import torch

from lanczosnet_torch.serve import MicroBatcher, Predictor


class ModelServer:
    """Named Predictors, each on its device behind a MicroBatcher."""

    def __init__(self, max_delay_ms: float = 5.0, inflight: int = 1):
        self.max_delay_ms = max_delay_ms
        self.inflight = inflight
        self._batchers: dict[str, MicroBatcher] = {}
        self._predictors: dict[str, Predictor] = {}

    @classmethod
    def from_run_dirs(
        cls,
        runs: Mapping[str, str | Path],
        batch_size: int = 64,
        max_delay_ms: float = 5.0,
        warmup: bool = True,
        inflight: int = 1,
        device: str | torch.device | None = None,
    ) -> "ModelServer":
        from lanczosnet_torch.export import is_artifact_dir, load_predictor

        srv = cls(max_delay_ms=max_delay_ms, inflight=inflight)
        for name, run_dir in runs.items():
            if is_artifact_dir(run_dir):
                predictor = load_predictor(run_dir, device=device)
            else:
                predictor = Predictor.from_run_dir(run_dir, batch_size=batch_size, device=device)
            srv.add_model(name, predictor, warmup=warmup)
        return srv

    def add_model(self, name: str, predictor: Predictor, warmup: bool = True) -> None:
        if warmup:
            predictor.warmup()  # the first request pays no build or first launch
        self._predictors[name] = predictor
        self._batchers[name] = MicroBatcher(
            predictor, max_delay_ms=self.max_delay_ms, inflight=self.inflight
        )

    def has_model(self, name: str) -> bool:
        return name in self._batchers

    def batcher(self, name: str) -> MicroBatcher:
        return self._batchers[name]

    def models(self) -> list[dict]:
        return [
            {"name": name, "n_max": p.n_max, "batch_size": p.batch_size, "num_task": p.num_task}
            for name, p in sorted(self._predictors.items())
        ]

    def predict(self, name: str, graphs: list[dict]) -> np.ndarray:
        """Submit every graph through the model's batcher (so it coalesces
        with other clients) and gather, blocking."""
        mb = self._batchers[name]
        futs = [mb.submit(g) for g in graphs]
        return np.stack([f.result() for f in futs])

    def stats(self, name: str) -> dict:
        return self._batchers[name].latency_stats()

    def close(self) -> None:
        for mb in self._batchers.values():
            mb.close()


def _decode_graph(obj) -> dict:
    """One graph of the JSON wire → a graph dict; ``ValueError`` or
    ``TypeError`` or ``KeyError`` on a malformed one."""
    if not isinstance(obj, dict):
        raise TypeError(f"a graph must be a JSON object, got {type(obj).__name__}")
    g = {"atom_type": np.asarray(obj["atom_type"], np.int32),
         "adj": np.asarray(obj["adj"], np.float32)}
    if g["adj"].ndim == 2:  # one edge type sent flat
        g["adj"] = g["adj"][None]
    if obj.get("node_feat") is not None:
        g["node_feat"] = np.asarray(obj["node_feat"], np.float32)
    return g


def decode_request(body: bytes) -> list[dict]:
    """A JSON request body → its graph dicts. Raises ``ValueError`` (or
    ``TypeError``, ``KeyError``) naming what is wrong: not JSON, not an
    object, ``graphs`` not a list, a graph that does not decode, or no
    graph at all."""
    req = json.loads(body or b"{}")
    if not isinstance(req, dict):
        raise ValueError(f"the body must be a JSON object, got {type(req).__name__}")
    graphs = req.get("graphs", [])
    if not isinstance(graphs, list):
        raise ValueError(f"'graphs' must be a list, got {type(graphs).__name__}")
    out = [_decode_graph(g) for g in graphs]
    if not out:
        raise ValueError("empty graphs")
    return out


_PREDICT_RE = re.compile(r"^/v1/models/([\w.-]+):predict$")
_STATS_RE = re.compile(r"^/v1/models/([\w.-]+)/stats$")


class _HTTPServer(ThreadingHTTPServer):
    # socketserver's listen(5) backlog resets connections as soon as more
    # than 5 clients connect at once; a deep accept queue lets bursts wait
    request_queue_size = 256
    daemon_threads = True


def make_http_server(
    server: ModelServer, host: str = "127.0.0.1", port: int = 0
) -> ThreadingHTTPServer:
    """Build (not start) the HTTP front. ``port=0`` picks a free port,
    read back from ``httpd.server_address``; start it with
    :func:`serve_forever_in_thread`."""

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"  # keep-alive

        def _json(self, code: int, payload: dict) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):  # quiet; latency lives in stats
            pass

        def do_GET(self):
            if self.path == "/healthz":
                return self._json(200, {"status": "ok"})
            if self.path == "/v1/models":
                return self._json(200, {"models": server.models()})
            m = _STATS_RE.match(self.path)
            if m:
                name = m.group(1)
                if not server.has_model(name):
                    return self._json(404, {"error": f"no model {name!r}"})
                return self._json(200, server.stats(name))
            return self._json(404, {"error": "not found"})

        def do_POST(self):
            m = _PREDICT_RE.match(self.path)
            if not m:
                return self._json(404, {"error": "not found"})
            name = m.group(1)
            if not server.has_model(name):
                return self._json(404, {"error": f"no model {name!r}"})
            try:
                length = int(self.headers.get("Content-Length", 0))
                graphs = decode_request(self.rfile.read(length))
            except (KeyError, ValueError, TypeError) as exc:
                return self._json(400, {"error": f"bad request: {exc}"})
            try:
                preds = server.predict(name, graphs)
            except Exception as exc:  # a model error is the client's 500, not the server's end
                return self._json(500, {"error": str(exc)})
            return self._json(200, {"predictions": preds.tolist()})

    return _HTTPServer((host, port), Handler)


def serve_forever_in_thread(httpd: ThreadingHTTPServer) -> threading.Thread:
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    return t


def main(argv=None) -> None:
    """``python -m lanczosnet_torch.serve_http --model NAME=DIR ...
    [--native] [--device cpu]``."""
    import argparse

    ap = argparse.ArgumentParser(
        description="LanczosNet model server (PyTorch port): the stdlib HTTP front, or with "
                    "--native the C++ epoll front (the port's counterpart of the JAX "
                    "package's native server)")
    ap.add_argument(
        "--model", action="append", required=True, metavar="NAME=DIR",
        help="model name and a run directory (the port's or the JAX package's) or an "
             "artifact directory (repeatable)",
    )
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--batch-size", type=int, default=64)
    ap.add_argument("--max-delay-ms", type=float, default=5.0)
    ap.add_argument("--inflight", type=int, default=1,
                    help="MicroBatcher's dispatched but unfetched batches")
    ap.add_argument("--device", default=None,
                    help="torch device of the models (default: the card; 'cpu' when asked)")
    ap.add_argument("--native", action="store_true",
                    help="serve through the C++ epoll front (serve_native.py); fails if it "
                         "cannot be built")
    args = ap.parse_args(argv)

    runs = dict(spec.split("=", 1) for spec in args.model)
    srv = ModelServer.from_run_dirs(
        runs, batch_size=args.batch_size, max_delay_ms=args.max_delay_ms,
        inflight=args.inflight, device=args.device,
    )
    try:
        if args.native:
            from lanczosnet_torch.serve_native import NativeFront

            front = NativeFront(srv, host=args.host, port=args.port)
            print(f"serving {sorted(runs)} on http://{front.host}:{front.port} (native front)",
                  flush=True)
            try:
                threading.Event().wait()
            except KeyboardInterrupt:
                pass
            finally:
                front.close()
            return
        httpd = make_http_server(srv, host=args.host, port=args.port)
        host, port = httpd.server_address
        print(f"serving {sorted(runs)} on http://{host}:{port}", flush=True)
        try:
            httpd.serve_forever()
        except KeyboardInterrupt:
            pass
        finally:
            httpd.server_close()
    finally:
        srv.close()


if __name__ == "__main__":
    main()
