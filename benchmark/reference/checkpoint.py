"""Reading an MMD checkpoint directory: `ema_model.msgpack` (a flax
parameter tree written by `flax.serialization.to_bytes`) and `args.yaml`.

The msgpack reader decodes the subset flax writes: maps, arrays, str, bin,
int, float, nil, bool, and ndarray leaves as ext type 1 whose payload is
the msgpack of (shape, dtype name, C-order bytes). The YAML reader takes
the flat `key: scalar` and `key:` + `- item` lines of `args.yaml`.
"""
from __future__ import annotations

import os
import struct
from typing import Any, Dict

import numpy as np


def _unpack(buf: memoryview, pos: int):
    b = buf[pos]
    pos += 1

    def take(n):
        return bytes(buf[pos:pos + n]), pos + n

    def num(fmt):
        size = struct.calcsize(fmt)
        return struct.unpack(fmt, buf[pos:pos + size])[0], pos + size

    if b <= 0x7F:
        return b, pos
    if b >= 0xE0:
        return b - 0x100, pos
    if 0x80 <= b <= 0x8F:
        return _unpack_map(buf, pos, b & 0x0F)
    if 0x90 <= b <= 0x9F:
        return _unpack_list(buf, pos, b & 0x0F)
    if 0xA0 <= b <= 0xBF:
        raw, pos = take(b & 0x1F)
        return raw.decode(), pos
    simple = {0xC0: None, 0xC2: False, 0xC3: True}
    if b in simple:
        return simple[b], pos
    sized = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I", 0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}
    if b in sized:
        n, pos = num(sized[b])
        raw, pos = take(n)
        return (raw if b < 0xD9 else raw.decode()), pos
    if b in (0xC7, 0xC8, 0xC9):
        n, pos = num({0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}[b])
        code, pos = num(">b")
        raw, pos = take(n)
        return _ext(code, raw), pos
    if b in (0xD4, 0xD5, 0xD6, 0xD7, 0xD8):
        code, pos = num(">b")
        raw, pos = take(1 << (b - 0xD4))
        return _ext(code, raw), pos
    scalars = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
               0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
    if b in scalars:
        return num(scalars[b])
    if b in (0xDC, 0xDD):
        n, pos = num(">H" if b == 0xDC else ">I")
        return _unpack_list(buf, pos, n)
    if b in (0xDE, 0xDF):
        n, pos = num(">H" if b == 0xDE else ">I")
        return _unpack_map(buf, pos, n)
    raise ValueError(f"msgpack: unsupported type byte 0x{b:02x}")


def _unpack_list(buf, pos, n):
    out = []
    for _ in range(n):
        v, pos = _unpack(buf, pos)
        out.append(v)
    return out, pos


def _unpack_map(buf, pos, n):
    out = {}
    for _ in range(n):
        k, pos = _unpack(buf, pos)
        out[k], pos = _unpack(buf, pos)
    return out, pos


def _ext(code: int, payload: bytes) -> np.ndarray:
    if code != 1:
        raise ValueError(f"msgpack: unsupported ext type {code}")
    (shape, dtype, raw), _ = _unpack(memoryview(payload), 0)
    dtype = dtype.decode() if isinstance(dtype, bytes) else dtype
    return np.frombuffer(raw, dtype=np.dtype(dtype)).reshape(shape).copy()


def read_msgpack(path: str) -> Any:
    with open(path, "rb") as f:
        data = f.read()
    out, pos = _unpack(memoryview(data), 0)
    if pos != len(data):
        raise ValueError(f"msgpack: {len(data) - pos} trailing bytes in {path}")
    return out


def _scalar(text: str):
    s = text.strip()
    for cast in (int, float):
        try:
            return cast(s)
        except ValueError:
            pass
    return s


def read_args(path: str) -> Dict[str, Any]:
    """The flat `args.yaml` of a checkpoint: scalars and lists of scalars."""
    out: Dict[str, Any] = {}
    key = None
    with open(path) as f:
        for line in f:
            line = line.rstrip("\n")
            if not line.strip():
                continue
            if line.startswith("- ") and key is not None:
                out[key].append(_scalar(line[2:]))
                continue
            key, _, rest = line.partition(":")
            out[key] = _scalar(rest) if rest.strip() else []
    return out


def load_checkpoint(model_dir: str) -> Dict[str, Any]:
    """{"params": the EMA parameter tree, "args": args.yaml}."""
    tree = read_msgpack(os.path.join(model_dir, "ema_model.msgpack"))
    return {"params": tree.get("params", tree),
            "args": read_args(os.path.join(model_dir, "args.yaml"))}
