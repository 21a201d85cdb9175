"""The subset of MessagePack that flax checkpoints use, written from the
format specification (https://github.com/msgpack/msgpack/blob/master/spec.md):
maps with str keys, arrays, ints, floats (as float 64), nil, bools, str,
bin and ext.  Arrays of numbers travel as flax's extension types
(`flax.serialization._msgpack_ext_pack`):

- ext 1, an ndarray: the msgpack of (shape, dtype name, C-order bytes);
- ext 3, a numpy scalar: the same of a 0-d array.

`packb` gives the bytes `flax.serialization.msgpack_serialize(tree,
in_place=True)` (= `flax.serialization.to_bytes` of a state dict) gives:
maps keep their insertion order, the smallest encoding of each int, str 8
for short strings and bin for bytes.  Leaves may be numpy arrays and
scalars or torch tensors; bfloat16 (which numpy lacks) travels by name and
unpacks to a CPU `torch.bfloat16` tensor.  flax splits arrays of more than
2^30 bytes into `__msgpack_chunked_array__` maps: `packb` refuses such an
array and `unpackb` such a map, with an error that says so.
"""

from __future__ import annotations

import struct

import numpy as np
import torch

EXT_NDARRAY = 1
EXT_NPSCALAR = 3
MAX_CHUNK_SIZE = 2**30  # flax.serialization.MAX_CHUNK_SIZE


# ---------------------------------------------------------------------------
# encode
# ---------------------------------------------------------------------------

def _pack_int(x: int, out: bytearray) -> None:
    if 0 <= x < 0x80:
        out.append(x)
    elif -0x20 <= x < 0:
        out.append(x & 0xFF)
    elif x >= 0:
        for code, fmt, lim in ((0xCC, ">B", 1 << 8), (0xCD, ">H", 1 << 16),
                               (0xCE, ">I", 1 << 32), (0xCF, ">Q", 1 << 64)):
            if x < lim:
                out.append(code)
                out += struct.pack(fmt, x)
                return
        raise OverflowError(f"int too large for msgpack: {x}")
    else:
        for code, fmt, lim in ((0xD0, ">b", 1 << 7), (0xD1, ">h", 1 << 15),
                               (0xD2, ">i", 1 << 31), (0xD3, ">q", 1 << 63)):
            if x >= -lim:
                out.append(code)
                out += struct.pack(fmt, x)
                return
        raise OverflowError(f"int too small for msgpack: {x}")


def _pack_len(n: int, out: bytearray, fix_base, fix_lim, codes) -> None:
    """A length header: the fix form below `fix_lim` (if any), else the
    first of `codes` ((code, struct format, limit), ...) that holds n."""
    if fix_base is not None and n < fix_lim:
        out.append(fix_base | n)
        return
    for code, fmt, lim in codes:
        if n < lim:
            out.append(code)
            out += struct.pack(fmt, n)
            return
    raise OverflowError(f"length too large for msgpack: {n}")


_STR = ((0xD9, ">B", 1 << 8), (0xDA, ">H", 1 << 16), (0xDB, ">I", 1 << 32))
_BIN = ((0xC4, ">B", 1 << 8), (0xC5, ">H", 1 << 16), (0xC6, ">I", 1 << 32))
_ARR = ((0xDC, ">H", 1 << 16), (0xDD, ">I", 1 << 32))
_MAP = ((0xDE, ">H", 1 << 16), (0xDF, ">I", 1 << 32))
_FIXEXT = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
_EXT = ((0xC7, ">B", 1 << 8), (0xC8, ">H", 1 << 16), (0xC9, ">I", 1 << 32))


def _array_fields(x) -> tuple[tuple, str, bytes]:
    """(shape, dtype name, C-order bytes) of a numpy array or torch tensor."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().contiguous()
        if x.dtype == torch.bfloat16:
            return tuple(x.shape), "bfloat16", x.view(torch.int16).numpy().tobytes()
        x = x.numpy()
    if x.dtype.hasobject or x.dtype.isalignedstruct:
        raise ValueError("object and structured dtypes cannot be serialized")
    return tuple(int(s) for s in x.shape), x.dtype.name, x.tobytes("C")


def _pack_ext(code: int, data: bytes, out: bytearray) -> None:
    n = len(data)
    if n in _FIXEXT:
        out.append(_FIXEXT[n])
    else:
        _pack_len(n, out, None, 0, _EXT)
    out += struct.pack(">b", code)
    out += data


def _pack(x, out: bytearray) -> None:
    if x is None:
        out.append(0xC0)
    elif x is True:
        out.append(0xC3)
    elif x is False:
        out.append(0xC2)
    elif type(x) is int:
        _pack_int(x, out)
    elif type(x) is float:
        out.append(0xCB)
        out += struct.pack(">d", x)
    elif type(x) is str:
        b = x.encode("utf-8")
        _pack_len(len(b), out, 0xA0, 32, _STR)
        out += b
    elif type(x) in (bytes, bytearray):
        _pack_len(len(x), out, None, 0, _BIN)
        out += x
    elif type(x) in (list, tuple):
        _pack_len(len(x), out, 0x90, 16, _ARR)
        for v in x:
            _pack(v, out)
    elif type(x) is dict:
        _pack_len(len(x), out, 0x80, 16, _MAP)
        for k, v in x.items():
            _pack(k, out)
            _pack(v, out)
    elif isinstance(x, (np.ndarray, torch.Tensor)):
        shape, name, data = _array_fields(x)
        if len(data) > MAX_CHUNK_SIZE:
            raise ValueError(f"an array of {len(data)} bytes needs flax's chunked-array form "
                             f"(above {MAX_CHUNK_SIZE} bytes), which this codec does not write")
        _pack_ext(EXT_NDARRAY, packb((shape, name, data)), out)
    elif isinstance(x, np.generic):
        _pack_ext(EXT_NPSCALAR, packb(_array_fields(np.asarray(x))), out)
    else:
        raise TypeError(f"cannot serialize {type(x).__name__}")


def packb(tree) -> bytes:
    """The msgpack bytes of `tree` (see the module docstring)."""
    out = bytearray()
    _pack(tree, out)
    return bytes(out)


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def _array_from_fields(shape, name: str, data: bytes):
    if name == "bfloat16":
        t = torch.frombuffer(bytearray(data), dtype=torch.int16).view(torch.bfloat16)
        return t.reshape(tuple(shape))
    return np.frombuffer(data, dtype=np.dtype(name)).reshape(tuple(shape), order="C").copy()


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        b = self.data[self.pos:self.pos + n].tobytes()
        self.pos += n
        return b

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def ext(self, n: int):
        code = self.unpack(">b")
        data = self.take(n)
        if code == EXT_NDARRAY:
            return _array_from_fields(*_fields(data))
        if code == EXT_NPSCALAR:
            a = _array_from_fields(*_fields(data))
            return a if isinstance(a, torch.Tensor) else a[()]
        raise ValueError(f"unsupported msgpack extension type {code}")

    def value(self):
        b = self.take(1)[0]
        if b < 0x80:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.value() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return self.take(b & 0x1F).decode("utf-8")
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        ints = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q", 0xCA: ">f", 0xCB: ">d"}
        if b in ints:
            return self.unpack(ints[b])
        lens = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I", 0xC4: ">B", 0xC5: ">H", 0xC6: ">I",
                0xDC: ">H", 0xDD: ">I", 0xDE: ">H", 0xDF: ">I", 0xC7: ">B", 0xC8: ">H",
                0xC9: ">I"}
        if b in lens:
            n = self.unpack(lens[b])
            if b in (0xD9, 0xDA, 0xDB):
                return self.take(n).decode("utf-8")
            if b in (0xC4, 0xC5, 0xC6):
                return self.take(n)
            if b in (0xDC, 0xDD):
                return [self.value() for _ in range(n)]
            if b in (0xDE, 0xDF):
                return self.map(n)
            return self.ext(n)
        fixext = {v: k for k, v in _FIXEXT.items()}
        if b in fixext:
            return self.ext(fixext[b])
        raise ValueError(f"unsupported msgpack type byte 0x{b:02x}")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        if "__msgpack_chunked_array__" in out:
            raise ValueError("flax's chunked-array form (arrays above 2^30 bytes) is not "
                             "supported by this codec")
        return out


def _fields(data: bytes):
    shape, name, buf = _Reader(data).value()
    return shape, name.decode() if isinstance(name, bytes) else name, buf


def unpackb(data: bytes):
    """The tree that `packb` (or flax) wrote: dicts, lists, Python scalars,
    numpy arrays and scalars, and bfloat16 arrays as CPU torch tensors."""
    r = _Reader(data)
    out = r.value()
    if r.pos != len(r.data):
        raise ValueError("trailing bytes after the msgpack object")
    return out
