"""Minimal UBJSON (draft-12) encoder/decoder (a copy of
povar_tpu/utils/ubjson.py).

The reference saves ba_log both as .json and .ubjson (ba_log.cpp
save_json/save_ubjson via nlohmann::json); its Python tooling prefers
the compact binary form for big logs (python/rootba/log.py). This
self-contained codec covers the value types those logs use: null, bool,
int, float64, string, array, object.
"""

from __future__ import annotations

import struct
from typing import Any, Tuple


def _encode_int(n: int) -> bytes:
    if -(2**7) <= n < 2**7:
        return b"i" + struct.pack(">b", n)
    if 0 <= n < 2**8:
        return b"U" + struct.pack(">B", n)
    if -(2**15) <= n < 2**15:
        return b"I" + struct.pack(">h", n)
    if -(2**31) <= n < 2**31:
        return b"l" + struct.pack(">i", n)
    return b"L" + struct.pack(">q", n)


def _encode_str_payload(s: str) -> bytes:
    raw = s.encode("utf-8")
    return _encode_int(len(raw)) + raw


def dumps(value: Any) -> bytes:
    """Encode a python value to UBJSON bytes."""
    if value is None:
        return b"Z"
    if value is True:
        return b"T"
    if value is False:
        return b"F"
    if isinstance(value, int):
        return _encode_int(value)
    if isinstance(value, float):
        return b"D" + struct.pack(">d", value)
    if isinstance(value, str):
        return b"S" + _encode_str_payload(value)
    if isinstance(value, (list, tuple)):
        out = [b"["]
        for v in value:
            out.append(dumps(v))
        out.append(b"]")
        return b"".join(out)
    if isinstance(value, dict):
        out = [b"{"]
        for k, v in value.items():
            out.append(_encode_str_payload(str(k)))
            out.append(dumps(v))
        out.append(b"}")
        return b"".join(out)
    raise TypeError(f"unsupported type for ubjson: {type(value)}")


_INT_FMT = {b"i": ">b", b"U": ">B", b"I": ">h", b"l": ">i", b"L": ">q"}


def _decode(buf: bytes, pos: int) -> Tuple[Any, int]:
    tag = buf[pos : pos + 1]
    pos += 1
    if tag == b"Z":
        return None, pos
    if tag == b"T":
        return True, pos
    if tag == b"F":
        return False, pos
    if tag in _INT_FMT:
        fmt = _INT_FMT[tag]
        size = struct.calcsize(fmt)
        return struct.unpack(fmt, buf[pos : pos + size])[0], pos + size
    if tag == b"d":
        return struct.unpack(">f", buf[pos : pos + 4])[0], pos + 4
    if tag == b"D":
        return struct.unpack(">d", buf[pos : pos + 8])[0], pos + 8
    if tag == b"S":
        n, pos = _decode(buf, pos)
        return buf[pos : pos + n].decode("utf-8"), pos + n
    if tag == b"[":
        out = []
        while buf[pos : pos + 1] != b"]":
            v, pos = _decode(buf, pos)
            out.append(v)
        return out, pos + 1
    if tag == b"{":
        obj = {}
        while buf[pos : pos + 1] != b"}":
            # key: string payload without the 'S' tag
            n, pos = _decode(buf, pos)
            key = buf[pos : pos + n].decode("utf-8")
            pos += n
            obj[key], pos = _decode(buf, pos)
        return obj, pos + 1
    raise ValueError(f"bad ubjson tag {tag!r} at {pos - 1}")


def loads(buf: bytes) -> Any:
    value, pos = _decode(buf, 0)
    return value
