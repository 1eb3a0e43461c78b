"""The subset of MessagePack that checkpoints use, in plain Python.

``packb`` writes what ``msgpack.packb(obj)`` (msgpack ≥ 1.0, its
defaults) writes for nil, bool, int (−2^63 … 2^64 − 1), float (as
float64), str, bytes (as bin), list and tuple (as array) and dict (as
map, keys in insertion order), each in its smallest encoding. ``default``
turns any other object into one of these first. ``unpackb`` reads those
types back: str as str, bin as bytes, array as list, map as dict with its
keys as written (str or bytes); ``object_hook`` is applied to every map.
Nothing here imports the ``msgpack`` package, so the port runs without it.
"""
from __future__ import annotations

import struct


def packb(obj, *, default=None) -> bytes:
    out = bytearray()
    _pack(obj, out, default)
    return bytes(out)


def _pack(obj, out: bytearray, default) -> None:
    if obj is None:
        out.append(0xC0)
    elif obj is True:
        out.append(0xC3)
    elif obj is False:
        out.append(0xC2)
    elif isinstance(obj, int):
        _pack_int(obj, out)
    elif isinstance(obj, float):
        out += b"\xcb" + struct.pack(">d", obj)
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        _head(out, len(data), 0xA0, 32, (0xD9, 0xDA, 0xDB))
        out += data
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        data = bytes(obj)
        _head(out, len(data), None, 0, (0xC4, 0xC5, 0xC6))
        out += data
    elif isinstance(obj, (list, tuple)):
        _head(out, len(obj), 0x90, 16, (None, 0xDC, 0xDD))
        for x in obj:
            _pack(x, out, default)
    elif isinstance(obj, dict):
        _head(out, len(obj), 0x80, 16, (None, 0xDE, 0xDF))
        for k, v in obj.items():
            _pack(k, out, default)
            _pack(v, out, default)
    elif default is not None:
        conv = default(obj)
        if conv is obj:
            raise TypeError(f"can not serialize {type(obj).__name__!r} object")
        _pack(conv, out, default)
    else:
        raise TypeError(f"can not serialize {type(obj).__name__!r} object")


def _head(out: bytearray, n: int, fix, fix_limit: int, codes) -> None:
    """A length header: the fix form below ``fix_limit``, else the 8-, 16-
    or 32-bit form of ``codes`` (None where the type has no such form)."""
    if fix is not None and n < fix_limit:
        out.append(fix | n)
    elif codes[0] is not None and n < 2**8:
        out += bytes((codes[0], n))
    elif n < 2**16:
        out += bytes((codes[1],)) + struct.pack(">H", n)
    elif n < 2**32:
        out += bytes((codes[2],)) + struct.pack(">I", n)
    else:
        raise ValueError(f"msgpack: a length of {n} does not fit 32 bits")


def _pack_int(v: int, out: bytearray) -> None:
    if 0 <= v < 0x80:
        out.append(v)
    elif -32 <= v < 0:
        out.append(v & 0xFF)
    elif v >= 0:
        for code, fmt, top in ((0xCC, ">B", 2**8), (0xCD, ">H", 2**16), (0xCE, ">I", 2**32),
                               (0xCF, ">Q", 2**64)):
            if v < top:
                out += bytes((code,)) + struct.pack(fmt, v)
                return
        raise OverflowError(f"msgpack: int {v} is too big")
    else:
        for code, fmt, low in ((0xD0, ">b", -2**7), (0xD1, ">h", -2**15), (0xD2, ">i", -2**31),
                               (0xD3, ">q", -2**63)):
            if v >= low:
                out += bytes((code,)) + struct.pack(fmt, v)
                return
        raise OverflowError(f"msgpack: int {v} is too small")


# code -> (struct format, size) of the fixed-width scalars
_SCALARS = {0xCA: (">f", 4), 0xCB: (">d", 8), 0xCC: (">B", 1), 0xCD: (">H", 2),
            0xCE: (">I", 4), 0xCF: (">Q", 8), 0xD0: (">b", 1), 0xD1: (">h", 2),
            0xD2: (">i", 4), 0xD3: (">q", 8)}
# code -> (kind, struct format of the length, its size)
_SIZED = {0xD9: ("str", ">B", 1), 0xDA: ("str", ">H", 2), 0xDB: ("str", ">I", 4),
          0xC4: ("bin", ">B", 1), 0xC5: ("bin", ">H", 2), 0xC6: ("bin", ">I", 4),
          0xDC: ("array", ">H", 2), 0xDD: ("array", ">I", 4),
          0xDE: ("map", ">H", 2), 0xDF: ("map", ">I", 4)}


def unpackb(data, *, object_hook=None):
    view = memoryview(data)
    obj, pos = _unpack(view, 0, object_hook)
    if pos != len(view):
        raise ValueError(f"msgpack: {len(view) - pos} bytes left after the object")
    return obj


def _unpack(buf, pos: int, hook):
    code = buf[pos]
    pos += 1
    if code < 0x80:
        return code, pos
    if code >= 0xE0:
        return code - 0x100, pos
    if code == 0xC0:
        return None, pos
    if code in (0xC2, 0xC3):
        return code == 0xC3, pos
    if code in _SCALARS:
        fmt, size = _SCALARS[code]
        return struct.unpack_from(fmt, buf, pos)[0], pos + size
    if 0xA0 <= code <= 0xBF:
        kind, n = "str", code & 0x1F
    elif 0x90 <= code <= 0x9F:
        kind, n = "array", code & 0x0F
    elif 0x80 <= code <= 0x8F:
        kind, n = "map", code & 0x0F
    elif code in _SIZED:
        kind, fmt, size = _SIZED[code]
        n = struct.unpack_from(fmt, buf, pos)[0]
        pos += size
    else:
        raise ValueError(f"msgpack: type byte 0x{code:02x} is outside the checkpoint subset")
    if kind in ("str", "bin"):
        raw = bytes(buf[pos: pos + n])
        if len(raw) != n:
            raise ValueError("msgpack: truncated data")
        return (raw.decode("utf-8") if kind == "str" else raw), pos + n
    if kind == "array":
        items = []
        for _ in range(n):
            x, pos = _unpack(buf, pos, hook)
            items.append(x)
        return items, pos
    out = {}
    for _ in range(n):
        k, pos = _unpack(buf, pos, hook)
        out[k], pos = _unpack(buf, pos, hook)
    return (hook(out) if hook is not None else out), pos
