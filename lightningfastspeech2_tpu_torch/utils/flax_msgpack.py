"""Reads and writes the bytes of ``flax.serialization.to_bytes``, without
msgpack or flax.

flax writes a state dict as MessagePack: maps with str keys, lists, ints,
floats, bools, None, str and bin, and its own extension types: 1 an ndarray
(a packed ``(shape, dtype name, C-order bytes)``) and 3 a numpy scalar
(packed as an ndarray of shape ()). Arrays above 2**30 bytes are split
into a map marked ``__msgpack_chunked_array__``, which ``restore`` joins
again. This is the decoding half of the MessagePack format for that
subset (flax's Python complex, extension 2, is refused), and ``to_bytes``
the encoding half for trees of numpy arrays (no chunking: arrays up to
2**30 bytes).
"""

from __future__ import annotations

import struct
from typing import Any

import numpy as np

EXT_NDARRAY, EXT_NPSCALAR = 1, 3


class _Reader:
    def __init__(self, data: bytes, raw: bool = False):
        self.data, self.pos, self.raw = memoryview(data), 0, raw

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("truncated MessagePack data")
        out = self.data[self.pos:self.pos + n].tobytes()
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(">" + fmt, self.take(struct.calcsize(">" + fmt)))[0]

    def string(self, n: int):
        b = self.take(n)
        return b if self.raw else b.decode("utf-8")

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
            return self.string(b & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        if b in (0xC4, 0xC5, 0xC6):                      # bin 8 / 16 / 32
            return self.take(self.unpack("BHI"[b - 0xC4]))
        if b in (0xC7, 0xC8, 0xC9):                      # ext 8 / 16 / 32
            n = self.unpack("BHI"[b - 0xC7])
            return _ext(self.unpack("b"), self.take(n))
        if b == 0xCA:
            return self.unpack("f")
        if b == 0xCB:
            return self.unpack("d")
        if 0xCC <= b <= 0xD3:                            # uint / int 8..64
            return self.unpack("BHIQbhiq"[b - 0xCC])
        if 0xD4 <= b <= 0xD8:                            # fixext 1..16
            code = self.unpack("b")
            return _ext(code, self.take(1 << (b - 0xD4)))
        if b in (0xD9, 0xDA, 0xDB):                      # str 8 / 16 / 32
            return self.string(self.unpack("BHI"[b - 0xD9]))
        if b in (0xDC, 0xDD):                            # array 16 / 32
            return [self.obj() for _ in range(self.unpack("HI"[b - 0xDC]))]
        if b in (0xDE, 0xDF):                            # map 16 / 32
            return self.map(self.unpack("HI"[b - 0xDE]))
        raise ValueError(f"unsupported MessagePack type byte 0x{b:02x}")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.obj()
            out[k] = self.obj()
        return out


def unpackb(data: bytes, raw: bool = False) -> Any:
    """One MessagePack object from ``data`` (str as bytes with ``raw``)."""
    r = _Reader(data, raw)
    out = r.obj()
    if r.pos != len(r.data):
        raise ValueError("extra bytes after the MessagePack object")
    return out


def _ndarray(data: bytes) -> np.ndarray:
    shape, dtype_name, buf = unpackb(data, raw=True)
    if dtype_name == b"bfloat16":
        raise ValueError("bfloat16 arrays are not supported; save the state in float32")
    return np.frombuffer(buf, dtype=np.dtype(dtype_name.decode())).reshape(shape, order="C")


def _ext(code: int, data: bytes) -> Any:
    if code == EXT_NDARRAY:
        return _ndarray(data)
    if code == EXT_NPSCALAR:
        return _ndarray(data)[()]
    raise ValueError(f"unsupported MessagePack extension type {code}")


def _unchunk(tree: Any) -> Any:
    if isinstance(tree, dict):
        if tree.get("__msgpack_chunked_array__"):
            # flax writes the shape and the chunks as {"0": ..., "1": ...}
            shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
            chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
            return np.concatenate(chunks).reshape(shape)
        return {k: _unchunk(v) for k, v in tree.items()}
    return tree


def restore(data: bytes) -> Any:
    """The state dict that ``flax.serialization.to_bytes`` encoded (what
    ``flax.serialization.msgpack_restore`` returns): nested dicts of numpy
    arrays."""
    return _unchunk(unpackb(data))



class _Writer:
    def __init__(self):
        self.parts = []

    def put(self, fmt: str, *values) -> None:
        self.parts.append(struct.pack(">" + fmt, *values))

    def sized(self, n: int, fix: int, fix_max: int, codes) -> None:
        """A length header: the fix form ``fix | n`` up to ``fix_max``, else
        the 8 / 16 / 32-bit form whose type bytes are ``codes``."""
        if fix is not None and n <= fix_max:
            self.put("B", fix | n)
        elif codes[0] is not None and n < 1 << 8:
            self.put("BB", codes[0], n)
        elif n < 1 << 16:
            self.put("BH", codes[1], n)
        else:
            self.put("BI", codes[2], n)

    def obj(self, x: Any) -> None:
        if isinstance(x, int):
            self.int(x)
        elif isinstance(x, str):
            b = x.encode("utf-8")
            self.sized(len(b), 0xA0, 31, (0xD9, 0xDA, 0xDB))
            self.parts.append(b)
        elif isinstance(x, (bytes, bytearray)):
            self.sized(len(x), None, -1, (0xC4, 0xC5, 0xC6))
            self.parts.append(bytes(x))
        elif isinstance(x, (list, tuple)):
            self.sized(len(x), 0x90, 15, (None, 0xDC, 0xDD))
            for v in x:
                self.obj(v)
        elif isinstance(x, dict):
            self.sized(len(x), 0x80, 15, (None, 0xDE, 0xDF))
            for k, v in x.items():
                self.obj(k)
                self.obj(v)
        elif isinstance(x, np.ndarray):
            self.ext(EXT_NDARRAY, _ndarray_bytes(x))
        else:
            raise TypeError(f"cannot pack {type(x).__name__}")

    def int(self, v: int) -> None:
        """A non-negative int (an array's dimension)."""
        if v <= 0x7F:
            self.put("B", v)
            return
        for code, fmt, top in ((0xCC, "B", 1 << 8), (0xCD, "H", 1 << 16),
                               (0xCE, "I", 1 << 32), (0xCF, "Q", 1 << 64)):
            if v < top:
                self.put("B" + fmt, code, v)
                return
        raise OverflowError(v)

    def ext(self, code: int, data: bytes) -> None:
        fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
        if len(data) in fixed:
            self.put("Bb", fixed[len(data)], code)
        else:
            self.sized(len(data), None, -1, (0xC7, 0xC8, 0xC9))
            self.put("b", code)
        self.parts.append(data)


def packb(obj: Any) -> bytes:
    """``obj`` as MessagePack: ints, str, bytes, lists, tuples, dicts and
    numpy arrays (flax's extension 1), each in its shortest form, as
    msgpack-python writes them: what a tree of arrays needs."""
    w = _Writer()
    w.obj(obj)
    return b"".join(w.parts)


def _ndarray_bytes(arr: np.ndarray) -> bytes:
    if arr.dtype.name == "bfloat16":
        raise ValueError("bfloat16 arrays are not supported; save the state in float32")
    if arr.nbytes > 1 << 30:
        raise ValueError("arrays above 2**30 bytes are not supported (flax chunks them)")
    return packb((tuple(int(d) for d in arr.shape), arr.dtype.name, arr.tobytes("C")))


def to_bytes(state: Any) -> bytes:
    """The bytes ``flax.serialization.to_bytes`` writes for a state dict of
    nested str-keyed dicts of numpy arrays: ``restore`` reads them back, and
    so does flax's ``from_bytes`` against a template of that tree."""
    return packb(state)
