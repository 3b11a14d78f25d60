"""Reader of the checkpoints the JAX package writes.

``lanczosnet_tpu/train/checkpoint.py`` stores a training state as flax's
msgpack (``flax.serialization.msgpack_serialize`` of its state dict): a
map of maps with string keys, each array as msgpack ext type 1 wrapping
the msgpack of ``(shape, dtype name, raw C-order bytes)``, a numpy
scalar as ext 3 in the same form, a complex number as ext 2 wrapping
``(real, imag)``. This module decodes that subset of msgpack in plain
Python, so the port reads such a run without flax or the ``msgpack``
package. Arrays of more than 2**30 bytes, which flax splits into
``__msgpack_chunked_array__`` maps, and ext codes other than 1–3 raise,
naming what they met.

    state = msgpack_restore(Path("checkpoints/best.msgpack").read_bytes())
    state["params"]       # nested dicts of numpy arrays
"""

from __future__ import annotations

import struct
from typing import Any, Callable

import numpy as np

CHUNKED_KEY = "__msgpack_chunked_array__"
EXT_NDARRAY, EXT_COMPLEX, EXT_NPSCALAR = 1, 2, 3

# fixed-width headers: first byte → (struct format of the payload, kind)
_FIXED = {
    0xCC: (">B", "int"), 0xCD: (">H", "int"), 0xCE: (">I", "int"), 0xCF: (">Q", "int"),
    0xD0: (">b", "int"), 0xD1: (">h", "int"), 0xD2: (">i", "int"), 0xD3: (">q", "int"),
    0xCA: (">f", "float"), 0xCB: (">d", "float"),
}
# length-prefixed headers: first byte → (struct format of the length, kind)
_SIZED = {
    0xD9: (">B", "str"), 0xDA: (">H", "str"), 0xDB: (">I", "str"),
    0xC4: (">B", "bin"), 0xC5: (">H", "bin"), 0xC6: (">I", "bin"),
    0xDC: (">H", "array"), 0xDD: (">I", "array"),
    0xDE: (">H", "map"), 0xDF: (">I", "map"),
    0xC7: (">B", "ext"), 0xC8: (">H", "ext"), 0xC9: (">I", "ext"),
}
_FIXEXT = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}


class _Reader:
    def __init__(self, data: bytes, raw: bool, ext_hook: Callable[[int, bytes], Any]):
        self.data = memoryview(data)
        self.pos = 0
        self.raw = raw
        self.ext_hook = ext_hook

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError(f"msgpack data ends inside an object at byte {self.pos}")
        out = bytes(self.data[self.pos: self.pos + n])
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def obj(self) -> Any:
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.obj() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return self.str(b & 0x1F)
        if b in (0xC0, 0xC2, 0xC3):
            return {0xC0: None, 0xC2: False, 0xC3: True}[b]
        if b in _FIXED:
            return self.unpack(_FIXED[b][0])
        if b in _FIXEXT:
            code = self.unpack(">b")
            return self.ext_hook(code, self.take(_FIXEXT[b]))
        if b in _SIZED:
            fmt, kind = _SIZED[b]
            n = self.unpack(fmt)
            if kind == "str":
                return self.str(n)
            if kind == "bin":
                return self.take(n)
            if kind == "array":
                return [self.obj() for _ in range(n)]
            if kind == "map":
                return self.map(n)
            code = self.unpack(">b")
            return self.ext_hook(code, self.take(n))
        raise ValueError(f"msgpack type byte 0x{b:02x} at byte {self.pos - 1} is not decoded here")

    def str(self, n: int):
        raw = self.take(n)
        return raw if self.raw else raw.decode("utf-8")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.obj()
            out[key] = self.obj()
        return out


def _unknown_ext(code: int, data: bytes):
    raise ValueError(f"msgpack ext type {code} ({len(data)} bytes) is not one flax writes")


def unpackb(data: bytes, raw: bool = False,
            ext_hook: Callable[[int, bytes], Any] = _unknown_ext) -> Any:
    """One msgpack object from ``data``, as ``msgpack.unpackb`` gives it
    (``raw``: strings as bytes); each ext object goes to
    ``ext_hook(code, payload)``. Trailing bytes raise."""
    reader = _Reader(data, raw, ext_hook)
    out = reader.obj()
    if reader.pos != len(data):
        raise ValueError(f"{len(data) - reader.pos} bytes after the msgpack object")
    return out


def _dtype(name: bytes) -> np.dtype:
    name = name.decode()
    if name == "bfloat16":  # numpy has no bfloat16: widened below
        return np.dtype(np.uint16)
    return np.dtype(name)


def _ndarray(payload: bytes) -> np.ndarray:
    shape, name, buf = unpackb(payload, raw=True)
    arr = np.frombuffer(buf, dtype=_dtype(name)).reshape(shape)
    if name == b"bfloat16":
        arr = (arr.astype(np.uint32) << 16).view(np.float32)
    return arr


def _flax_ext(code: int, payload: bytes):
    if code == EXT_NDARRAY:
        return _ndarray(payload)
    if code == EXT_NPSCALAR:
        return _ndarray(payload)[()]
    if code == EXT_COMPLEX:
        real, imag = unpackb(payload)
        return complex(real, imag)
    return _unknown_ext(code, payload)


def _refuse_chunked(tree: Any, path: str = "") -> None:
    if isinstance(tree, dict):
        if CHUNKED_KEY in tree:
            raise ValueError(
                f"{path or 'the state'} is an array flax split into chunks ({CHUNKED_KEY}): "
                "arrays over 2**30 bytes are not read here")
        for key, val in tree.items():
            _refuse_chunked(val, f"{path}/{key}")


def msgpack_restore(data: bytes) -> Any:
    """What ``flax.serialization.msgpack_restore`` gives for ``data``:
    nested dicts of numpy arrays and scalars (bfloat16 arrays widened to
    float32)."""
    tree = unpackb(data, ext_hook=_flax_ext)
    _refuse_chunked(tree)
    return tree
