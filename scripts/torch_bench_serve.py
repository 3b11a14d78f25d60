#!/usr/bin/env python3
"""Serving saturation sweep of the port: sustained req/s and batch occupancy against load.

Counterpart of ``scripts/bench_serve.py``, with its protocol and options.
An in-process ``ModelServer`` holds the flagship LanczosNet (N_max 32,
K=20 Ritz pairs computed on the card inside each request batch by the
shared-memory Lanczos kernel, batch 64, 5 ms deadline; weights drawn from
a seed) behind the stdlib HTTP front (``serve_http.py``) or, with
``--native``, the C++ epoll front (``serve_native.py:NativeFront``). For
each concurrency level C, C client threads post single-graph predict
requests back to back for ``--window`` seconds, one keep-alive connection
each; the payloads are ``synthetic_qm8_graphs(64, seed=3, n_lo=8,
n_hi=28)``, as JSON or, with ``--binary``, the LNG1 wire. A row a level:
completed req/s, the clients' p50/p95 of the whole round trip, the
requests that failed, and the batcher's mean occupancy (requests over
batches) in that window. Then the ``saturation:`` line, or with
``--inflight-sweep`` the ``best:`` line; on stderr, the shared-memory
Lanczos kernel's launches in the process. Requests that fail are counted in
their row, the first failure's message goes to stderr, and the tool
exits 1. Run from the repository's root:

    python3 scripts/torch_bench_serve.py                          # on the card
    python3 scripts/torch_bench_serve.py --native --binary
    python3 scripts/torch_bench_serve.py --legacy-wire            # float32 request wire
    python3 scripts/torch_bench_serve.py --device cpu --window 1 --concurrency 1,4
"""

from __future__ import annotations

import argparse
import http.client
import json
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "scripts"))

from lanczosnet_torch.data.qm8 import synthetic_qm8_graphs  # noqa: E402
from lanczosnet_torch.models import build_model  # noqa: E402
from lanczosnet_torch.ops import lanczos_cuda  # noqa: E402
from lanczosnet_torch.serve import Predictor  # noqa: E402
from lanczosnet_torch.serve_http import (  # noqa: E402
    ModelServer,
    make_http_server,
    serve_forever_in_thread,
)
from lanczosnet_torch.serve_native import NativeFront, encode_graphs_binary  # noqa: E402
from torch_bench import K, N, model_config  # noqa: E402

MODEL = "lanczosnet"
NUM_PAYLOADS = 64


def make_payloads(n_graphs: int, n_max: int, binary: bool = False) -> list[bytes]:
    graphs = synthetic_qm8_graphs(n_graphs, seed=3, n_lo=8, n_hi=n_max - 4)
    if binary:
        return [encode_graphs_binary([g]) for g in graphs]
    return [json.dumps({"graphs": [{"atom_type": np.asarray(g["atom_type"]).tolist(),
                                    "adj": np.asarray(g["adj"]).tolist()}]}).encode()
            for g in graphs]


class Outcome:
    """One client's count of answers, failures and latencies, and its
    first failure's message."""

    def __init__(self):
        self.done, self.errors, self.lat, self.first_error = 0, 0, [], None

    def failed(self, what: str) -> None:
        self.errors += 1
        if self.first_error is None:
            self.first_error = what


def client_loop(host, port, payloads, stop, out, idx):
    res = Outcome()
    i = idx  # stagger the request mix across clients
    conn = None  # one keep-alive connection a client; reconnect after a failure
    while not stop.is_set():
        t0 = time.perf_counter()
        try:
            if conn is None:
                conn = http.client.HTTPConnection(host, port, timeout=30)
            conn.request("POST", f"/v1/models/{MODEL}:predict",
                         body=payloads[i % len(payloads)],
                         headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            body = resp.read()
            if resp.status == 200 and (b"predictions" in body or body[:4] == b"LNP1"):
                res.done += 1
                res.lat.append(time.perf_counter() - t0)
            else:
                res.failed(f"HTTP {resp.status}: {body[:200]!r}")
        except (OSError, http.client.HTTPException) as exc:
            res.failed(f"{type(exc).__name__}: {exc}")
            if conn is not None:
                conn.close()
            conn = None
        i += 1
    if conn is not None:
        conn.close()
    out[idx] = res


def direct_loop(batcher, graphs, stop, out, idx):
    """A client that submits to the ``MicroBatcher`` in process."""
    res = Outcome()
    i = idx
    while not stop.is_set():
        t0 = time.perf_counter()
        try:
            batcher.submit(graphs[i % len(graphs)]).result(timeout=30)
            res.done += 1
            res.lat.append(time.perf_counter() - t0)
        except Exception as exc:  # counted in the row and reported on stderr
            res.failed(f"{type(exc).__name__}: {exc}")
        i += 1
    out[idx] = res


def build_predictor(batch_size: int, compact_wire: bool, device, seed: int = 0) -> Predictor:
    """The flagship at N_max 32, K=20, weights drawn from ``seed``."""
    model = build_model(model_config())
    model.init_weights(torch.Generator().manual_seed(seed))
    return Predictor(model, model.state_dict(), n_max=N, batch_size=batch_size, num_eig_vec=K,
                     compact_wire=compact_wire, device=device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--window", type=float, default=8.0)
    ap.add_argument("--batch-size", type=int, default=64)
    ap.add_argument("--deadline-ms", type=float, default=5.0)
    ap.add_argument("--concurrency", type=str, default="1,4,8,16,32,64",
                    help="comma-separated client counts")
    ap.add_argument("--inflight", type=int, default=1,
                    help="MicroBatcher dispatched-but-unfetched depth")
    ap.add_argument("--legacy-wire", action="store_true",
                    help="turn the compact uint8 request wire off (A/B baseline)")
    ap.add_argument("--direct", action="store_true",
                    help="skip the HTTP front: clients submit to the MicroBatcher "
                         "in process (the batcher and device ceiling without HTTP)")
    ap.add_argument("--native", action="store_true",
                    help="serve through the C++ epoll front instead of the stdlib "
                         "ThreadingHTTPServer")
    ap.add_argument("--binary", action="store_true",
                    help="clients send the binary graph wire instead of JSON "
                         "(the native front decodes both)")
    ap.add_argument("--ab-wire", action="store_true",
                    help="run every concurrency level twice, binary wire then JSON, in "
                         "one process, rows tagged with \"wire\"")
    ap.add_argument("--inflight-sweep", type=str, default=None, metavar="DEPTHS",
                    help="comma-separated MicroBatcher pipeline depths; rebuilds the "
                         "ModelServer and front per depth in one process and runs every "
                         "--concurrency level at each")
    ap.add_argument("--device", default=None, help="default: the card")
    args = ap.parse_args(argv)
    levels = [int(s) for s in args.concurrency.split(",")]

    pred = build_predictor(args.batch_size, not args.legacy_wire, args.device)
    direct_graphs = (synthetic_qm8_graphs(NUM_PAYLOADS, seed=3, n_lo=8, n_hi=N - 4)
                     if args.direct else None)
    payloads = make_payloads(NUM_PAYLOADS, N, binary=args.binary)
    failures: list[str] = []

    def make_front(srv):
        if args.native:
            front = NativeFront(srv, port=0)
            return None, front, front.host, front.port
        httpd = make_http_server(srv)
        serve_forever_in_thread(httpd)
        host, port = httpd.server_address
        return httpd, None, host, port

    def close(srv, httpd, front):
        if httpd is not None:
            httpd.shutdown()
            httpd.server_close()
        if front is not None:
            front.close()
        srv.close()

    def run_level(c, srv, host, port, payloads=payloads):
        before = srv.stats(MODEL)
        stop = threading.Event()
        out: dict = {}
        threads = [
            threading.Thread(target=direct_loop,
                             args=(srv.batcher(MODEL), direct_graphs, stop, out, i))
            if args.direct else
            threading.Thread(target=client_loop, args=(host, port, payloads, stop, out, i))
            for i in range(c)
        ]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        time.sleep(args.window)
        stop.set()
        for t in threads:
            t.join()
        dt = time.perf_counter() - t0
        done = sum(v.done for v in out.values())
        errors = sum(v.errors for v in out.values())
        failures.extend(v.first_error for v in out.values() if v.first_error)
        lat = np.asarray([x for v in out.values() for x in v.lat], np.float64)
        after = srv.stats(MODEL)
        d_req = after.get("count", 0) - before.get("count", 0)
        d_batch = after.get("batches", 0) - before.get("batches", 0)
        return {
            "clients": c,
            "req_per_sec": round(done / dt, 1),
            "p50_ms": round(float(np.percentile(lat, 50)) * 1e3, 1) if lat.size else None,
            "p95_ms": round(float(np.percentile(lat, 95)) * 1e3, 1) if lat.size else None,
            "errors": errors,
            "mean_batch_occupancy": round(d_req / d_batch, 2) if d_batch else None,
        }

    if args.ab_wire:
        both = {"binary": make_payloads(NUM_PAYLOADS, N, binary=True),
                "json": make_payloads(NUM_PAYLOADS, N, binary=False)}
        srv = ModelServer(max_delay_ms=args.deadline_ms, inflight=args.inflight)
        srv.add_model(MODEL, pred)
        httpd, front, host, port = make_front(srv)
        for c in levels:
            for wire, pl in both.items():
                row = run_level(c, srv, host, port, payloads=pl)
                row["wire"] = wire
                if front is not None and wire == "json":
                    # the C++ transcode carried the JSON load
                    row["transcoded_total"] = front.transcoded()
                print(json.dumps(row), flush=True)
        close(srv, httpd, front)

    if args.inflight_sweep:
        # one process: the predictor is shared, so only the first depth
        # pays the kernel build and first launches; repeat depths in the
        # list to interleave them
        rows = []
        for depth in [int(s) for s in args.inflight_sweep.split(",")]:
            srv = ModelServer(max_delay_ms=args.deadline_ms, inflight=depth)
            srv.add_model(MODEL, pred)
            httpd, front, host, port = make_front(srv)
            for c in levels:
                row = run_level(c, srv, host, port)
                row["inflight"] = depth
                rows.append(row)
                print(json.dumps(row), flush=True)
            close(srv, httpd, front)
        best = max(rows, key=lambda r: r["req_per_sec"])
        print(f"best: {best['req_per_sec']} req/s at inflight {best['inflight']} "
              f"({best['clients']} clients)", flush=True)
    elif not args.ab_wire:
        srv = ModelServer(max_delay_ms=args.deadline_ms, inflight=args.inflight)
        srv.add_model(MODEL, pred)  # the warm-up builds the kernel and launches each wire
        httpd, front, host, port = make_front(srv)
        rows = []
        for c in levels:
            row = run_level(c, srv, host, port)
            rows.append(row)
            print(json.dumps(row), flush=True)
        best = max(rows, key=lambda r: r["req_per_sec"])
        print(f"saturation: {best['req_per_sec']} req/s at {best['clients']} clients, "
              f"mean batch occupancy {best['mean_batch_occupancy']}", flush=True)
        close(srv, httpd, front)

    # one launch a request batch (and the warm-ups'); 0 on the CPU, which
    # runs the plain version
    print(f"lanczos_tridiag launches: {lanczos_cuda.launches.count}", file=sys.stderr, flush=True)
    if failures:
        print(f"{len(failures)} clients saw failed requests; the first: {failures[0]}",
              file=sys.stderr, flush=True)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
