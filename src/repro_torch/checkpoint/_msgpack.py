"""A MessagePack encoder and decoder for the checkpoint manifest.

The manifest holds maps, arrays, strings, integers, floats, booleans and
nil, and nothing else.  ``packb`` writes the bytes that
``msgpack.packb`` writes for such a value with its defaults (floats as
float64, each integer, string and container in its smallest format,
maps in insertion order); ``unpackb`` reads what ``msgpack.packb``
writes for it (strings come back as ``str``, arrays as lists).  The
port keeps its own so that a checkpoint needs no package beyond torch.
"""
from __future__ import annotations

import struct


def packb(obj) -> bytes:
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


def _pack(obj, out: bytearray) -> None:
    if obj is None:
        out.append(0xC0)
    elif obj is True:
        out.append(0xC3)
    elif obj is False:
        out.append(0xC2)
    elif isinstance(obj, int):
        _pack_int(int(obj), out)
    elif isinstance(obj, float):
        out.append(0xCB)
        out += struct.pack(">d", obj)
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        _header(len(raw), out, fix=(0xA0, 31), sizes=(
            (0xFF, 0xD9, ">B"), (0xFFFF, 0xDA, ">H"),
            (0xFFFFFFFF, 0xDB, ">I")))
        out += raw
    elif isinstance(obj, (list, tuple)):
        _header(len(obj), out, fix=(0x90, 15), sizes=(
            (0xFFFF, 0xDC, ">H"), (0xFFFFFFFF, 0xDD, ">I")))
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, dict):
        _header(len(obj), out, fix=(0x80, 15), sizes=(
            (0xFFFF, 0xDE, ">H"), (0xFFFFFFFF, 0xDF, ">I")))
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f"can not serialize {type(obj).__name__!r} object")


def _header(n: int, out: bytearray, fix, sizes) -> None:
    if n <= fix[1]:
        out.append(fix[0] | n)
        return
    for limit, code, fmt in sizes:
        if n <= limit:
            out.append(code)
            out += struct.pack(fmt, n)
            return
    raise ValueError(f"object of length {n} is too large")


def _pack_int(v: int, out: bytearray) -> None:
    if 0 <= v < 0x80:
        out.append(v)
    elif -0x20 <= v < 0:
        out.append(v & 0xFF)
    elif v >= 0:
        for limit, code, fmt in ((0xFF, 0xCC, ">B"), (0xFFFF, 0xCD, ">H"),
                                 (0xFFFFFFFF, 0xCE, ">I"),
                                 (0xFFFFFFFFFFFFFFFF, 0xCF, ">Q")):
            if v <= limit:
                out.append(code)
                out += struct.pack(fmt, v)
                return
        raise OverflowError("integer out of range")
    else:
        for limit, code, fmt in ((-0x80, 0xD0, ">b"), (-0x8000, 0xD1, ">h"),
                                 (-0x80000000, 0xD2, ">i"),
                                 (-0x8000000000000000, 0xD3, ">q")):
            if v >= limit:
                out.append(code)
                out += struct.pack(fmt, v)
                return
        raise OverflowError("integer out of range")


def unpackb(data: bytes):
    buf = memoryview(bytes(data))
    obj, end = _unpack(buf, 0)
    if end != len(buf):
        raise ValueError(f"{len(buf) - end} extra bytes after the object")
    return obj


_FIXED = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
          0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q", 0xCB: ">d"}
_LENGTHS = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I",      # str 8/16/32
            0xDC: ">H", 0xDD: ">I",                  # array 16/32
            0xDE: ">H", 0xDF: ">I"}                  # map 16/32


def _unpack(buf: memoryview, i: int):
    if i >= len(buf):
        raise ValueError("truncated MessagePack data")
    b = buf[i]
    i += 1
    if b <= 0x7F:
        return b, i
    if b >= 0xE0:
        return b - 0x100, i
    if 0xA0 <= b <= 0xBF:
        return _str(buf, i, b & 0x1F)
    if 0x90 <= b <= 0x9F:
        return _array(buf, i, b & 0x0F)
    if 0x80 <= b <= 0x8F:
        return _map(buf, i, b & 0x0F)
    if b == 0xC0:
        return None, i
    if b == 0xC2:
        return False, i
    if b == 0xC3:
        return True, i
    if b in _FIXED:
        fmt = _FIXED[b]
        n = struct.calcsize(fmt)
        return struct.unpack_from(fmt, buf, i)[0], i + n
    if b in _LENGTHS:
        fmt = _LENGTHS[b]
        n = struct.unpack_from(fmt, buf, i)[0]
        i += struct.calcsize(fmt)
        if b in (0xD9, 0xDA, 0xDB):
            return _str(buf, i, n)
        if b in (0xDC, 0xDD):
            return _array(buf, i, n)
        return _map(buf, i, n)
    raise ValueError(f"unsupported MessagePack type byte 0x{b:02x}")


def _need(buf, i, n):
    if i + n > len(buf):
        raise ValueError("truncated MessagePack data")


def _str(buf, i, n):
    _need(buf, i, n)
    return bytes(buf[i:i + n]).decode("utf-8"), i + n


def _array(buf, i, n):
    out = []
    for _ in range(n):
        v, i = _unpack(buf, i)
        out.append(v)
    return out, i


def _map(buf, i, n):
    out = {}
    for _ in range(n):
        k, i = _unpack(buf, i)
        if not isinstance(k, str):
            raise ValueError(f"map key of type {type(k).__name__}")
        out[k], i = _unpack(buf, i)
    return out, i
