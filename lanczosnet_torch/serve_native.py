"""Native (C++ epoll) HTTP front, and the binary graph wire.

Counterpart of ``lanczosnet_tpu/serve_native.py``, over the port's own
fork of the front, ``lanczosnet_torch/native/servefront.cc`` (four
faults of the JAX package's ``native/servefront.cc`` repaired there; see
its header). The front is built with ``g++`` at first use into
``build/native/``, under a name keyed by a hash of the source and the
flags; a failed build or load raises with the compiler's output.

- One epoll thread in C++ accepts, parses, keeps connections alive and
  answers ``GET /healthz``, ``GET /v1/models`` and unknown models itself.
- One Python pull thread takes the queued request bodies in coalesced
  batches (``lnfront_next_batch``, one ctypes call a batch) and submits
  each graph to its model's ``MicroBatcher``; the last future of a
  request answers it from the batcher's completion thread
  (``lnfront_respond``). A request that does not decode gets a 400, any
  other error in handling it a 500, and the loop goes on.
- JSON bodies that the binary wire can carry (integral adjacency in
  [0, 255], no unknown keys) are transcoded to it in C++ before Python
  sees them, and the answer back to JSON; ``NativeFront.transcoded()``
  counts them. Other JSON bodies take the Python path of
  ``serve_http.decode_request``.

Binary wire (little-endian), version 1, byte for byte the JAX package's:

    request  = b"LNG1" u32:n_graphs graph*
    graph    = u16:n u8:e u8:0 u16:f u16:0
               i32[n]:atom_type  u8[e*n*n]:adj  f32[n*f]:node_feat
    response = b"LNP1" u32:n_graphs u32:num_task f32[n_graphs*num_task]

uint8 adjacency is the Predictor's compact device wire; graphs with
float edge weights use the JSON wire.
"""

from __future__ import annotations

import ctypes
import functools
import json
import struct
import threading
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from lanczosnet_torch.ops._build import Built, build_cxx
from lanczosnet_torch.serve_http import ModelServer, decode_request

SOURCE = Path(__file__).resolve().parent / "native" / "servefront.cc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build" / "native"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-pthread")

_MAGIC_REQ = b"LNG1"
_MAGIC_RESP = b"LNP1"
_MAX_GRAPHS = 4096


def build_front() -> Built:
    """Compile ``native/servefront.cc`` unless a build of this source and
    these flags exists (``Built.seconds`` is then 0.0); raises with g++'s
    output if the build fails."""
    return build_cxx("servefront", SOURCE, CXX_FLAGS, BUILD_DIR)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build_front().path))
    u8 = np.ctypeslib.ndpointer(np.uint8, flags="C")
    i32 = np.ctypeslib.ndpointer(np.int32, flags="C")
    for name, restype, argtypes in (
        ("lnfront_start", ctypes.c_int,
         [ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]),
        ("lnfront_register_model", ctypes.c_int, [ctypes.c_int, ctypes.c_char_p]),
        ("lnfront_set_models_json", None, [ctypes.c_int, ctypes.c_char_p]),
        ("lnfront_next_batch", ctypes.c_int,
         [ctypes.c_int, ctypes.c_int, ctypes.c_double, ctypes.c_double,
          np.ctypeslib.ndpointer(np.uint64, flags="C"), i32, i32, i32, u8, ctypes.c_int32]),
        ("lnfront_respond", None,
         [ctypes.c_int, ctypes.c_uint64, ctypes.c_int, ctypes.c_char_p, ctypes.c_int32,
          ctypes.c_int]),
        ("lnfront_served", ctypes.c_uint64, [ctypes.c_int]),
        ("lnfront_transcoded", ctypes.c_uint64, [ctypes.c_int]),
        ("lnfront_transcode", ctypes.c_int32,
         [ctypes.c_int, ctypes.c_char_p, ctypes.c_int32, u8, ctypes.c_int32]),
        ("lnfront_port", ctypes.c_int, [ctypes.c_int]),
        ("lnfront_stop", None, [ctypes.c_int]),
        ("lnfront_free", None, [ctypes.c_int]),
    ):
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = restype, argtypes
    return lib


# ---- binary graph codec ----------------------------------------------------


def encode_graphs_binary(graphs: Sequence[dict]) -> bytes:
    """Client-side encoder of the binary request wire (module docstring).
    ``adj`` must be integral in [0, 255]."""
    parts = [_MAGIC_REQ, struct.pack("<I", len(graphs))]
    for g in graphs:
        atom = np.ascontiguousarray(g["atom_type"], np.int32)
        adj = np.ascontiguousarray(g["adj"], np.uint8)
        if adj.ndim == 2:
            adj = adj[None]
        feat = g.get("node_feat")
        n, e = atom.shape[0], adj.shape[0]
        f = 0 if feat is None else int(np.asarray(feat).shape[-1])
        if adj.shape != (e, n, n):
            raise ValueError(f"adj shape {adj.shape} != ({e},{n},{n})")
        parts.append(struct.pack("<HBBHH", n, e, 0, f, 0))
        parts.append(atom.tobytes())
        parts.append(adj.tobytes())
        if f:
            parts.append(np.ascontiguousarray(feat, np.float32).tobytes())
    return b"".join(parts)


def decode_graphs_binary(body) -> list[dict]:
    """Server-side decoder: ``np.frombuffer`` views over ``body``, which
    must stay unchanged while the graphs are in use (``bytes``, not a
    reused buffer)."""
    if bytes(body[:4]) != _MAGIC_REQ:
        raise ValueError("bad magic")
    (count,) = struct.unpack_from("<I", body, 4)
    if count > _MAX_GRAPHS:
        raise ValueError(f"too many graphs: {count}")
    off = 8
    graphs = []
    for _ in range(count):
        n, e, _pad, f, _pad2 = struct.unpack_from("<HBBHH", body, off)
        off += 8
        atom = np.frombuffer(body, np.int32, n, off)
        off += 4 * n
        adj = np.frombuffer(body, np.uint8, e * n * n, off).reshape(e, n, n)
        off += e * n * n
        g = {"atom_type": atom, "adj": adj}
        if f:
            g["node_feat"] = np.frombuffer(body, np.float32, n * f, off).reshape(n, f)
            off += 4 * n * f
        graphs.append(g)
    if off != len(body):
        raise ValueError(f"trailing bytes: {len(body) - off}")
    return graphs


def decode_predictions_binary(body: bytes) -> np.ndarray:
    if body[:4] != _MAGIC_RESP:
        raise ValueError("bad magic")
    count, tasks = struct.unpack_from("<II", body, 4)
    return np.frombuffer(body, np.float32, count * tasks, 12).reshape(count, tasks)


def transcode(direction: str, body: bytes) -> Optional[bytes]:
    """The C++ wire transcoder, called directly: ``"json->lng1"`` (what
    the front does to a request body it can carry) or ``"lnp1->json"``
    (what it does to that request's answer). ``None`` where the front
    leaves the body to the Python JSON path."""
    d = {"json->lng1": 0, "lnp1->json": 1}[direction]
    out = np.empty(max(8 * len(body) + 4096, 1 << 16), np.uint8)  # JSON of f32 is ~4.5x
    n = _lib().lnfront_transcode(d, body, len(body), out, out.size)
    if n == -2:
        raise ValueError("transcode buffer too small")
    return None if n < 0 else out[:n].tobytes()


# ---- server ----------------------------------------------------------------


class _Pending:
    """Fan-in of one HTTP request's graph futures: the last future's
    callback (on the batcher's completion thread) encodes and answers."""

    __slots__ = ("front", "rid", "results", "remaining", "error", "binary", "lock")

    def __init__(self, front: "NativeFront", rid: int, n: int, binary: bool):
        self.front = front
        self.rid = rid
        self.results: list = [None] * n
        self.remaining = n
        self.error: Optional[BaseException] = None
        self.binary = binary
        self.lock = threading.Lock()

    def make_cb(self, i: int):
        def cb(fut):
            try:
                self.results[i] = fut.result()
            except Exception as exc:  # the request's 500
                self.error = exc
            with self.lock:
                self.remaining -= 1
                last = self.remaining == 0
            if last:
                self._respond()

        return cb

    def _respond(self) -> None:
        if self.error is not None:
            self.front._respond_json(self.rid, 500, {"error": str(self.error)})
            return
        preds = np.stack(self.results).astype(np.float32, copy=False)
        if self.binary:
            body = (_MAGIC_RESP + struct.pack("<II", preds.shape[0], preds.shape[1])
                    + np.ascontiguousarray(preds).tobytes())
            self.front._respond_raw(self.rid, 200, body, binary=True)
        else:
            self.front._respond_json(self.rid, 200, {"predictions": preds.tolist()})


class NativeFront:
    """The C++ epoll HTTP front bound to a :class:`ModelServer`.

    ``port=0`` binds a free port (read back from ``.port``). ``close``
    stops the front, joins the pull thread, and only then releases the
    front; it may be called more than once."""

    def __init__(
        self,
        server: ModelServer,
        host: str = "127.0.0.1",
        port: int = 0,
        backlog: int = 512,
        max_pull: int = 512,
        buf_mb: int = 64,
    ):
        lib = _lib()
        self._lib = lib
        self.server = server
        out_port = ctypes.c_int(0)
        self.sid = lib.lnfront_start(host.encode(), port, backlog, ctypes.byref(out_port))
        if self.sid < 0:
            raise OSError(f"lnfront_start failed for {host}:{port}")
        self.host = host
        self.port = out_port.value
        models = server.models()
        self._names = [m["name"] for m in models]
        for name in self._names:
            lib.lnfront_register_model(self.sid, name.encode())
        lib.lnfront_set_models_json(self.sid, json.dumps({"models": models}).encode())
        self._max_pull = max_pull
        self._ids = np.empty(max_pull, np.uint64)
        self._offs = np.empty(max_pull, np.int32)
        self._lens = np.empty(max_pull, np.int32)
        self._midx = np.empty(max_pull, np.int32)
        self._buf = np.empty(buf_mb << 20, np.uint8)
        self._stopped = threading.Event()
        self._close_lock = threading.Lock()
        self._pull = threading.Thread(target=self._pull_loop, daemon=True)
        self._pull.start()

    # answers may be queued from any thread (the C++ side locks)
    def _respond_raw(self, rid: int, status: int, body: bytes, binary: bool) -> None:
        self._lib.lnfront_respond(self.sid, rid, status, body, len(body), 0 if binary else 1)

    def _respond_json(self, rid: int, status: int, payload: dict) -> None:
        self._respond_raw(rid, status, json.dumps(payload).encode(), binary=False)

    def served(self) -> int:
        return int(self._lib.lnfront_served(self.sid))

    def transcoded(self) -> int:
        """JSON request bodies the front rewrote to the binary wire in C++."""
        return int(self._lib.lnfront_transcoded(self.sid))

    def _handle(self, rid: int, model_idx: int, body: bytes) -> None:
        try:
            if body[:4] == _MAGIC_REQ:
                graphs, binary = decode_graphs_binary(body), True
                if not graphs:
                    raise ValueError("empty graphs")
            else:
                graphs, binary = decode_request(bytes(body)), False
        except (ValueError, TypeError, KeyError, struct.error) as exc:
            self._respond_json(rid, 400, {"error": f"bad request: {exc}"})
            return
        mb = self.server.batcher(self._names[model_idx])
        pending = _Pending(self, rid, len(graphs), binary)
        # remaining starts at n, so no early completion answers before
        # every graph's callback has run
        for i, g in enumerate(graphs):
            mb.submit(g).add_done_callback(pending.make_cb(i))

    def _pull_loop(self) -> None:
        lib = self._lib
        while not self._stopped.is_set():
            n = lib.lnfront_next_batch(
                self.sid, self._max_pull, 100.0, 0.2,
                self._ids, self._offs, self._lens, self._midx, self._buf, self._buf.size,
            )
            if n < 0:
                return  # stopped
            mv = memoryview(self._buf)
            for i in range(n):
                rid = int(self._ids[i])
                off, ln = int(self._offs[i]), int(self._lens[i])
                try:
                    # a copy: decoded graphs are views that wait in the
                    # batcher's queue while the next pull reuses the buffer
                    self._handle(rid, int(self._midx[i]), bytes(mv[off:off + ln]))
                except Exception as exc:  # this request's 500; the loop serves on
                    self._respond_json(rid, 500, {"error": f"{type(exc).__name__}: {exc}"})

    def close(self) -> None:
        with self._close_lock:
            if self._stopped.is_set():
                return
            self._stopped.set()
            self._lib.lnfront_stop(self.sid)  # next_batch returns -1 from now on
            self._pull.join(timeout=10.0)
            if self._pull.is_alive():
                raise RuntimeError("the native front's pull thread did not stop")
            self._lib.lnfront_free(self.sid)
