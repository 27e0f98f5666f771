"""A msgpack decoder and encoder for the subset that flax checkpoints use.

Flax writes parameter trees with `flax.serialization.to_bytes`: nested maps
with str keys, and ndarray leaves as msgpack ext type 1 whose payload is
itself the msgpack of `(shape, dtype name, C-order bytes)`
(flax.serialization._ndarray_to_bytes). This module reads exactly that:
map, array, str, bin, int, float, nil, bool and ext type 1. Any other type
byte or ext code raises `ValueError`, so a file outside the subset fails
loudly instead of decoding wrongly.

`packb` writes the same subset as msgpack's packer does for flax (the
smallest encoding of each int, str, bin and ext length; floats as float64;
`use_bin_type=True`), so a tree of dicts and numpy arrays gives the bytes
`flax.serialization.msgpack_serialize` gives. Leaves of 2**30 bytes or
more, which flax would split into chunks, are refused.
"""
from __future__ import annotations

import struct
from typing import Any, Tuple

import numpy as np

EXT_NDARRAY = 1
_CHUNKED_KEY = "__msgpack_chunked_array__"
_MAX_LEAF_BYTES = 2 ** 30  # flax.serialization.MAX_CHUNK_SIZE


class _Reader:
    def __init__(self, data: bytes):
        self.buf = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > len(self.buf):
            raise ValueError("msgpack: truncated input")
        out = self.buf[self.pos:end]
        self.pos = end
        return out

    def unpack(self, fmt: str) -> Tuple:
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))


def _ext(code: int, payload: bytes) -> np.ndarray:
    if code != EXT_NDARRAY:
        raise ValueError(f"msgpack: unsupported ext type {code}")
    shape, dtype_name, buffer = unpackb(payload)
    if isinstance(dtype_name, bytes):
        dtype_name = dtype_name.decode()
    try:
        dtype = np.dtype(dtype_name)
    except TypeError as e:
        raise ValueError(f"msgpack: unsupported ndarray dtype {dtype_name!r}") from e
    return np.frombuffer(buffer, dtype=dtype).reshape(shape).copy()


def _obj(r: _Reader) -> Any:
    (b,) = r.unpack("B")
    if b <= 0x7F:
        return b
    if b >= 0xE0:
        return b - 0x100
    if 0x80 <= b <= 0x8F:
        return _map(r, b & 0x0F)
    if 0x90 <= b <= 0x9F:
        return [_obj(r) for _ in range(b & 0x0F)]
    if 0xA0 <= b <= 0xBF:
        return bytes(r.take(b & 0x1F)).decode()
    if b == 0xC0:
        return None
    if b == 0xC2:
        return False
    if b == 0xC3:
        return True
    if b in (0xC4, 0xC5, 0xC6):
        (n,) = r.unpack({0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}[b])
        return bytes(r.take(n))
    if b in (0xC7, 0xC8, 0xC9):
        (n,) = r.unpack({0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}[b])
        (code,) = r.unpack(">b")
        return _ext(code, bytes(r.take(n)))
    if b == 0xCA:
        return r.unpack(">f")[0]
    if b == 0xCB:
        return r.unpack(">d")[0]
    ints = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
            0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
    if b in ints:
        return r.unpack(ints[b])[0]
    if b in (0xD4, 0xD5, 0xD6, 0xD7, 0xD8):
        n = 1 << (b - 0xD4)
        (code,) = r.unpack(">b")
        return _ext(code, bytes(r.take(n)))
    if b in (0xD9, 0xDA, 0xDB):
        (n,) = r.unpack({0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}[b])
        return bytes(r.take(n)).decode()
    if b in (0xDC, 0xDD):
        (n,) = r.unpack(">H" if b == 0xDC else ">I")
        return [_obj(r) for _ in range(n)]
    if b in (0xDE, 0xDF):
        (n,) = r.unpack(">H" if b == 0xDE else ">I")
        return _map(r, n)
    raise ValueError(f"msgpack: unsupported type byte 0x{b:02x}")


def _map(r: _Reader, n: int) -> dict:
    out = {}
    for _ in range(n):
        k = _obj(r)
        out[k] = _obj(r)
    if _CHUNKED_KEY in out:
        raise ValueError("msgpack: chunked array leaves are not supported")
    return out


def unpackb(data: bytes) -> Any:
    """Decode one msgpack object that must span all of `data`."""
    r = _Reader(data)
    out = _obj(r)
    if r.pos != len(r.buf):
        raise ValueError(f"msgpack: {len(r.buf) - r.pos} trailing bytes")
    return out


def load_msgpack(path: str) -> Any:
    """Read a flax msgpack file into nested dicts of numpy arrays."""
    with open(path, "rb") as f:
        return unpackb(f.read())


# ----------------------------------------------------------------- writing
def _sized(out: bytearray, n: int, small: int, fix: int, codes: Tuple[int, ...]):
    """A length header: the fix form below `small`, else 8/16/32-bit."""
    if n < small:
        out.append(fix | n)
    elif codes[0] is not None and n < 1 << 8:
        out += struct.pack(">BB", codes[0], n)
    elif n < 1 << 16:
        out += struct.pack(">BH", codes[1], n)
    elif n < 1 << 32:
        out += struct.pack(">BI", codes[2], n)
    else:
        raise ValueError(f"msgpack: length {n} too large")


def _pack_int(out: bytearray, v: int):
    if 0 <= v < 0x80:
        out.append(v)
    elif -32 <= v < 0:
        out.append(v & 0xFF)
    elif v >= 0:
        for code, fmt, top in ((0xCC, ">BB", 1 << 8), (0xCD, ">BH", 1 << 16),
                               (0xCE, ">BI", 1 << 32), (0xCF, ">BQ", 1 << 64)):
            if v < top:
                out += struct.pack(fmt, code, v)
                return
        raise ValueError(f"msgpack: int {v} too large")
    else:
        for code, fmt, low in ((0xD0, ">Bb", -(1 << 7)), (0xD1, ">Bh", -(1 << 15)),
                               (0xD2, ">Bi", -(1 << 31)), (0xD3, ">Bq", -(1 << 63))):
            if v >= low:
                out += struct.pack(fmt, code, v)
                return
        raise ValueError(f"msgpack: int {v} too small")


def _pack_ext(out: bytearray, code: int, payload: bytes):
    n = len(payload)
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        out.append(fixed[n])
    elif n < 1 << 8:
        out += struct.pack(">BB", 0xC7, n)
    elif n < 1 << 16:
        out += struct.pack(">BH", 0xC8, n)
    else:
        out += struct.pack(">BI", 0xC9, n)
    out += struct.pack(">b", code)
    out += payload


def _pack(out: bytearray, obj: Any):
    if obj is None:
        out.append(0xC0)
    elif obj is True or obj is False:
        out.append(0xC3 if obj else 0xC2)
    elif isinstance(obj, int):
        _pack_int(out, obj)
    elif isinstance(obj, float):
        out += struct.pack(">Bd", 0xCB, obj)
    elif isinstance(obj, str):
        b = obj.encode()
        _sized(out, len(b), 32, 0xA0, (0xD9, 0xDA, 0xDB))
        out += b
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        b = bytes(obj)
        _sized(out, len(b), 0, 0, (0xC4, 0xC5, 0xC6))
        out += b
    elif isinstance(obj, (list, tuple)):
        _sized(out, len(obj), 16, 0x90, (None, 0xDC, 0xDD))
        for v in obj:
            _pack(out, v)
    elif isinstance(obj, dict):
        _sized(out, len(obj), 16, 0x80, (None, 0xDE, 0xDF))
        for k, v in obj.items():
            if not isinstance(k, str):
                raise ValueError(f"msgpack: map key {k!r} is not a str")
            _pack(out, k)
            _pack(out, v)
    elif isinstance(obj, np.ndarray):
        if obj.dtype.hasobject or obj.dtype.names is not None:
            raise ValueError(f"msgpack: unsupported ndarray dtype {obj.dtype}")
        if obj.nbytes >= _MAX_LEAF_BYTES:
            raise ValueError("msgpack: an array leaf this large would be chunked")
        _pack_ext(out, EXT_NDARRAY, packb((tuple(obj.shape), obj.dtype.name,
                                           obj.tobytes("C"))))
    else:
        raise ValueError(f"msgpack: unsupported type {type(obj).__name__}")


def packb(obj: Any) -> bytes:
    """Encode dicts (str keys), lists, scalars, bytes and numpy arrays."""
    out = bytearray()
    _pack(out, obj)
    return bytes(out)


def save_msgpack(path: str, tree: Any):
    """Write a tree of dicts and numpy arrays as flax's `to_bytes` does."""
    with open(path, "wb") as f:
        f.write(packb(tree))
