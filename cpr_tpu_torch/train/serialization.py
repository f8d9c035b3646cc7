"""The subset of flax's msgpack that `flax.serialization.to_bytes` writes
for a params tree, in plain Python (the card's machine has neither flax
nor a promise of `msgpack`).

A params tree is a nested map of str keys whose leaves are numpy arrays.
flax packs it with `msgpack.packb(tree, default=_msgpack_ext_pack,
strict_types=True)` (flax/serialization.py:396-415): a map is a fixmap,
map16 or map32; a key a fixstr, str8, str16 or str32; an array the ext
type 1 (`_MsgpackExtType.ndarray`) whose payload is itself
`packb((shape, dtype.name, arr.tobytes("C")), use_bin_type=True)`: a
3-array of (an array of unsigned ints, a str, a bin). Every integer,
string and length takes msgpack's smallest form, as msgpack-python
writes it, so `to_bytes` here gives flax's bytes for the same tree, key
order included (flax keeps the dict's insertion order; a tree that went
through `jax.tree.map` has its keys sorted). Arrays above flax's 1 GiB
chunk size are refused.
"""

from __future__ import annotations

import struct

import numpy as np

_EXT_NDARRAY = 1
_MAX_ARRAY_BYTES = 2 ** 30  # flax's MAX_CHUNK_SIZE


def _uint(n: int) -> bytes:
    if n < 0:
        raise ValueError(f"negative integer {n} outside the params format")
    if n < 0x80:
        return bytes([n])
    for tag, fmt, top in ((0xCC, ">B", 0xFF), (0xCD, ">H", 0xFFFF),
                          (0xCE, ">I", 0xFFFFFFFF)):
        if n <= top:
            return bytes([tag]) + struct.pack(fmt, n)
    return b"\xcf" + struct.pack(">Q", n)


def _str(s: str) -> bytes:
    b = s.encode("utf-8")
    n = len(b)
    if n < 32:
        return bytes([0xA0 | n]) + b
    if n <= 0xFF:
        return b"\xd9" + struct.pack(">B", n) + b
    if n <= 0xFFFF:
        return b"\xda" + struct.pack(">H", n) + b
    return b"\xdb" + struct.pack(">I", n) + b


def _bin(b: bytes) -> bytes:
    n = len(b)
    if n <= 0xFF:
        return b"\xc4" + struct.pack(">B", n) + b
    if n <= 0xFFFF:
        return b"\xc5" + struct.pack(">H", n) + b
    return b"\xc6" + struct.pack(">I", n) + b


def _array_header(n: int) -> bytes:
    if n < 16:
        return bytes([0x90 | n])
    if n <= 0xFFFF:
        return b"\xdc" + struct.pack(">H", n)
    return b"\xdd" + struct.pack(">I", n)


def _map_header(n: int) -> bytes:
    if n < 16:
        return bytes([0x80 | n])
    if n <= 0xFFFF:
        return b"\xde" + struct.pack(">H", n)
    return b"\xdf" + struct.pack(">I", n)


def _ext(code: int, data: bytes) -> bytes:
    n = len(data)
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        return bytes([fixed[n], code]) + data
    if n <= 0xFF:
        return b"\xc7" + struct.pack(">B", n) + bytes([code]) + data
    if n <= 0xFFFF:
        return b"\xc8" + struct.pack(">H", n) + bytes([code]) + data
    return b"\xc9" + struct.pack(">I", n) + bytes([code]) + data


def _ndarray(arr: np.ndarray) -> bytes:
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError("object and structured dtypes are not serialized")
    if arr.nbytes > _MAX_ARRAY_BYTES:
        raise ValueError("arrays above 1 GiB (flax chunks them) are not "
                         "part of the params format")
    payload = (_array_header(3) + _array_header(arr.ndim)
               + b"".join(_uint(int(d)) for d in arr.shape)
               + _str(arr.dtype.name) + _bin(arr.tobytes("C")))
    return _ext(_EXT_NDARRAY, payload)


def _pack(x) -> bytes:
    if isinstance(x, dict):
        out = [_map_header(len(x))]
        for k, v in x.items():
            if not isinstance(k, str):
                raise TypeError(f"params keys are str, got {type(k)}")
            out.append(_str(k))
            out.append(_pack(v))
        return b"".join(out)
    if isinstance(x, np.ndarray):
        return _ndarray(x)
    raise TypeError(f"{type(x).__name__} is outside the params format "
                    "(nested str-keyed maps of numpy arrays)")


def to_bytes(tree: dict) -> bytes:
    """flax.serialization.to_bytes of a params tree (nested dicts of str
    keys, numpy array leaves), byte for byte."""
    return _pack(tree)


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        b = bytes(self.data[self.pos:self.pos + n])
        self.pos += n
        return b

    def byte(self) -> int:
        return self.take(1)[0]

    def num(self, fmt: str) -> int:
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self):
        t = self.byte()
        if t < 0x80:
            return t
        if 0x80 <= t <= 0x8F:
            return self.map(t & 0x0F)
        if 0x90 <= t <= 0x9F:
            return [self.value() for _ in range(t & 0x0F)]
        if 0xA0 <= t <= 0xBF:
            return self.take(t & 0x1F).decode("utf-8")
        simple = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q"}
        if t in simple:
            return self.num(simple[t])
        sizes = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}
        if t in sizes:
            return self.take(self.num(sizes[t])).decode("utf-8")
        bins = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}
        if t in bins:
            return self.take(self.num(bins[t]))
        if t in (0xDC, 0xDD):
            n = self.num(">H" if t == 0xDC else ">I")
            return [self.value() for _ in range(n)]
        if t in (0xDE, 0xDF):
            return self.map(self.num(">H" if t == 0xDE else ">I"))
        fixed = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if t in fixed:
            n = fixed[t]
        elif t in (0xC7, 0xC8, 0xC9):
            n = self.num({0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}[t])
        else:
            raise ValueError(f"msgpack type 0x{t:02x} is outside the params "
                             "format")
        code = self.byte()
        if code != _EXT_NDARRAY:
            raise ValueError(f"msgpack ext type {code} is outside the params "
                             "format")
        return _array_from_payload(self.take(n))

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.value()
            if not isinstance(k, str):
                raise ValueError("params keys are str")
            out[k] = self.value()
        return out


def _array_from_payload(payload: bytes) -> np.ndarray:
    r = _Reader(payload)
    shape, name, buf = r.value()
    if r.pos != len(payload):
        raise ValueError("trailing bytes in an ndarray payload")
    return np.frombuffer(buf, dtype=np.dtype(name)).reshape(shape).copy()


def from_bytes(data: bytes) -> dict:
    """The params tree (nested dicts of numpy arrays) of bytes written by
    `flax.serialization.to_bytes` or `to_bytes`; raises ValueError on
    anything outside the format."""
    r = _Reader(data)
    tree = r.value()
    if r.pos != len(data):
        raise ValueError("trailing bytes after the params tree")
    if not isinstance(tree, dict):
        raise ValueError("a params file holds a map at its top")
    return tree
