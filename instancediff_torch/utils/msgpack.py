"""The flax msgpack format, read and written with the standard library and
numpy only (no ``msgpack``, no ``flax``): the bytes of
``flax.serialization.to_bytes`` and what ``msgpack_restore`` gives back.

The format (flax/serialization.py):
- nested dicts with string keys (flax turns lists and tuples into dicts keyed
  ``'0'``, ``'1'``, ...), python ints, floats, bools, None, strings and bytes;
- an array is msgpack ext type 1 whose payload is the msgpack array
  ``[shape, dtype name, raw C-order bytes]``; a numpy scalar is ext type 3
  with the same payload; a python complex is ext type 2 holding
  ``[real, imag]``;
- ``bfloat16`` travels as the dtype name ``b'bfloat16'``: decoded here as
  uint16 bits viewed as a ``torch.bfloat16`` tensor (numpy has no bfloat16);
- an array of more than ``MAX_CHUNK_SIZE`` bytes is split into the map
  ``{'__msgpack_chunked_array__': True, 'shape': {...}, 'chunks': {...}}``
  of flat chunks.

Decoding is O(bytes): arrays are ``np.frombuffer`` views of the input, with
no Python loop per element. Truncated or malformed input raises
``ValueError``."""

from __future__ import annotations

import struct
from typing import Any

import numpy as np
import torch

# flax's limit per array leaf (msgpack's hard limit is 2**31 - 1 bytes)
MAX_CHUNK_SIZE = 2**30
_CHUNKED = "__msgpack_chunked_array__"
EXT_NDARRAY, EXT_COMPLEX, EXT_NPSCALAR = 1, 2, 3


# ---------------------------------------------------------------- encoding


def _pack_int(out: list, n: int) -> None:
    if 0 <= n < 128:
        out.append(struct.pack("B", n))
    elif -32 <= n < 0:
        out.append(struct.pack("b", n))
    elif n >= 0:
        for code, fmt, top in ((0xcc, ">B", 2**8), (0xcd, ">H", 2**16), (0xce, ">I", 2**32),
                               (0xcf, ">Q", 2**64)):
            if n < top:
                out.append(bytes([code]) + struct.pack(fmt, n))
                return
        raise OverflowError(f"integer {n} does not fit msgpack's uint64")
    else:
        for code, fmt, low in ((0xd0, ">b", -2**7), (0xd1, ">h", -2**15), (0xd2, ">i", -2**31),
                               (0xd3, ">q", -2**63)):
            if n >= low:
                out.append(bytes([code]) + struct.pack(fmt, n))
                return
        raise OverflowError(f"integer {n} does not fit msgpack's int64")


def _pack_len(out: list, n: int, fix: int | None, fix_max: int, codes) -> None:
    """A length header: the fix form below ``fix_max``, then 8/16/32-bit forms
    (``codes``: their type bytes; None where the format has no such form)."""
    if fix is not None and n < fix_max:
        out.append(bytes([fix | n]))
        return
    for code, fmt, top in zip(codes, (">B", ">H", ">I"), (2**8, 2**16, 2**32)):
        if code is not None and n < top:
            out.append(bytes([code]) + struct.pack(fmt, n))
            return
    raise OverflowError(f"msgpack object of length {n} is too long")


def _pack_str(out: list, s: str) -> None:
    b = s.encode("utf-8")
    _pack_len(out, len(b), 0xa0, 32, (0xd9, 0xda, 0xdb))
    out.append(b)


def _pack_bin(out: list, b) -> None:
    _pack_len(out, len(b), None, 0, (0xc4, 0xc5, 0xc6))
    out.append(b)


def _pack_ext(out: list, code: int, data: bytes) -> None:
    fixext = {1: 0xd4, 2: 0xd5, 4: 0xd6, 8: 0xd7, 16: 0xd8}
    n = len(data)
    if n in fixext:
        out.append(bytes([fixext[n], code]))
    else:
        _pack_len(out, n, None, 0, (0xc7, 0xc8, 0xc9))
        out.append(struct.pack("b", code))
    out.append(data)


def _as_numpy(x):
    """(array's C-order bytes' source, dtype name) of a numpy array or a torch
    tensor (bfloat16 tensors as their uint16 bits)."""
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        a = t.numpy()
        return a, a.dtype.name
    if x.dtype.hasobject or x.dtype.isalignedstruct:
        raise ValueError("object and structured dtypes cannot be serialized")
    return x, x.dtype.name


def _ndarray_payload(x) -> bytes:
    """msgpack of ``[shape, dtype name, raw bytes]``, as flax packs it."""
    a, name = _as_numpy(x)
    out: list = [b"\x93"]
    _pack_len(out, a.ndim, 0x90, 16, (None, 0xdc, 0xdd))
    for d in a.shape:
        _pack_int(out, int(d))
    _pack_str(out, name)
    _pack_bin(out, np.ascontiguousarray(a).tobytes())
    return b"".join(out)


def _chunk(x) -> dict:
    """flax's ``_chunk``: a flat array cut into pieces of at most
    ``MAX_CHUNK_SIZE`` bytes."""
    size = max(1, int(MAX_CHUNK_SIZE / x.element_size() if isinstance(x, torch.Tensor)
                      else MAX_CHUNK_SIZE / x.dtype.itemsize))
    flat = x.reshape(-1)
    n = flat.shape[0]
    return {_CHUNKED: True, "shape": {str(i): int(d) for i, d in enumerate(x.shape)},
            "chunks": {str(j): flat[i:i + size] for j, i in enumerate(range(0, n, size))}}


def _nbytes(x) -> int:
    return x.numel() * x.element_size() if isinstance(x, torch.Tensor) else x.nbytes


def _pack(out: list, x, top: bool = False) -> None:
    if x is None:
        out.append(b"\xc0")
    elif x is True:
        out.append(b"\xc3")
    elif x is False:
        out.append(b"\xc2")
    elif type(x) is int:
        _pack_int(out, x)
    elif type(x) is float:
        out.append(b"\xcb" + struct.pack(">d", x))
    elif type(x) is str:
        _pack_str(out, x)
    elif type(x) is bytes:
        _pack_bin(out, x)
    elif type(x) is dict:
        _pack_len(out, len(x), 0x80, 16, (None, 0xde, 0xdf))
        for k, v in x.items():
            _pack(out, str(k))
            if isinstance(v, (np.ndarray, torch.Tensor)) and _nbytes(v) > MAX_CHUNK_SIZE:
                v = _chunk(v)
            _pack(out, v)
    elif isinstance(x, (list, tuple)):  # flax's state dict of a sequence
        _pack(out, {str(i): v for i, v in enumerate(x)}, top)
    elif isinstance(x, (np.ndarray, torch.Tensor)):
        if top and _nbytes(x) > MAX_CHUNK_SIZE:
            _pack(out, _chunk(x))
        else:
            _pack_ext(out, EXT_NDARRAY, _ndarray_payload(x))
    elif isinstance(x, np.generic):
        _pack_ext(out, EXT_NPSCALAR, _ndarray_payload(np.asarray(x)))
    elif type(x) is complex:
        inner: list = [b"\x92"]
        _pack(inner, x.real)
        _pack(inner, x.imag)
        _pack_ext(out, EXT_COMPLEX, b"".join(inner))
    else:
        raise TypeError(f"cannot serialize {type(x).__name__} in the flax msgpack format")


def to_bytes(tree: Any) -> bytes:
    """The bytes ``flax.serialization.to_bytes`` writes for ``tree`` (nested
    dicts, lists and tuples of numpy arrays, torch tensors, numpy scalars and
    python scalars), dict keys in the order given."""
    out: list = []
    _pack(out, tree, top=True)
    return b"".join(out)


# ---------------------------------------------------------------- decoding


class _Reader:
    def __init__(self, data):
        self.buf = memoryview(data).cast("B")
        self.pos = 0

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if n < 0 or end > len(self.buf):
            raise ValueError(f"msgpack data truncated at byte {self.pos} (wanted {n} more "
                             f"of {len(self.buf)})")
        view = self.buf[self.pos:end]
        self.pos = end
        return view

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]


_FIXEXT = {0xd4: 1, 0xd5: 2, 0xd6: 4, 0xd7: 8, 0xd8: 16}
_SIZED = {0xc4: ("bin", ">B"), 0xc5: ("bin", ">H"), 0xc6: ("bin", ">I"),
          0xc7: ("ext", ">B"), 0xc8: ("ext", ">H"), 0xc9: ("ext", ">I"),
          0xd9: ("str", ">B"), 0xda: ("str", ">H"), 0xdb: ("str", ">I"),
          0xdc: ("array", ">H"), 0xdd: ("array", ">I"),
          0xde: ("map", ">H"), 0xdf: ("map", ">I")}
_SCALARS = {0xca: ">f", 0xcb: ">d", 0xcc: ">B", 0xcd: ">H", 0xce: ">I", 0xcf: ">Q",
            0xd0: ">b", 0xd1: ">h", 0xd2: ">i", 0xd3: ">q"}


def _unpack(r: _Reader, raw: bool = False):
    b = r.unpack("B")
    if b < 0x80:
        return b
    if b >= 0xe0:
        return b - 0x100
    if b <= 0x8f:
        return _unpack_map(r, b & 0x0f, raw)
    if b <= 0x9f:
        return [_unpack(r, raw) for _ in range(b & 0x0f)]
    if b <= 0xbf:
        s = r.take(b & 0x1f)
        return bytes(s) if raw else str(s, "utf-8")
    if b == 0xc0:
        return None
    if b in (0xc2, 0xc3):
        return b == 0xc3
    if b in _SCALARS:
        return r.unpack(_SCALARS[b])
    if b in _FIXEXT:
        code = r.unpack("b")
        return _ext(code, r.take(_FIXEXT[b]))
    if b in _SIZED:
        kind, fmt = _SIZED[b]
        n = r.unpack(fmt)
        if kind == "bin":  # inside an ndarray payload: a view of the input
            return r.take(n) if raw else bytes(r.take(n))
        if kind == "str":
            s = r.take(n)
            return bytes(s) if raw else str(s, "utf-8")
        if kind == "ext":
            code = r.unpack("b")
            return _ext(code, r.take(n))
        if kind == "array":
            return [_unpack(r, raw) for _ in range(n)]
        return _unpack_map(r, n, raw)
    raise ValueError(f"unsupported msgpack type byte 0x{b:02x} at {r.pos - 1}")


def _unpack_map(r: _Reader, n: int, raw: bool) -> dict:
    out = {}
    for _ in range(n):
        k = _unpack(r, raw)
        out[k] = _unpack(r, raw)
    return out


def _array(data: memoryview):
    """An ext-1 payload as a numpy array viewing ``data`` (bfloat16: a
    ``torch.bfloat16`` tensor over the uint16 bits)."""
    r = _Reader(data)
    fields = _unpack(r, raw=True)
    if r.pos != len(r.buf) or not (isinstance(fields, list) and len(fields) == 3):
        raise ValueError("malformed msgpack ndarray payload")
    shape, name, buf = fields
    if name == b"bfloat16":
        a = np.frombuffer(buf, dtype=np.uint16).reshape(shape)
        return torch.from_numpy(a.copy()).view(torch.bfloat16)
    dtype = np.dtype(name.decode())
    if len(buf) != int(np.prod(shape, dtype=np.int64)) * dtype.itemsize:
        raise ValueError(f"ndarray payload of {len(buf)} bytes for shape {shape} {dtype}")
    return np.frombuffer(buf, dtype=dtype).reshape(shape)


def _ext(code: int, data: memoryview):
    if code == EXT_NDARRAY:
        return _array(data)
    if code == EXT_NPSCALAR:
        return _array(data)[()]
    if code == EXT_COMPLEX:
        re_im = _unpack(_Reader(data))
        return complex(re_im[0], re_im[1])
    raise ValueError(f"unknown msgpack ext type {code}")


def _unchunk(tree):
    """flax's ``_unchunk_array_leaves_in_place``."""
    if isinstance(tree, dict):
        if _CHUNKED in tree:
            shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
            chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
            if isinstance(chunks[0], torch.Tensor):
                return torch.cat(chunks).reshape(shape)
            return np.concatenate(chunks).reshape(shape)
        return {k: _unchunk(v) for k, v in tree.items()}
    return tree


def from_bytes(data) -> Any:
    """What ``flax.serialization.msgpack_restore`` gives back for ``data``:
    nested dicts of numpy arrays (read-only views of ``data``; bfloat16 as
    ``torch.bfloat16`` tensors), numpy scalars and python values."""
    r = _Reader(data)
    tree = _unpack(r)
    if r.pos != len(r.buf):
        raise ValueError(f"{len(r.buf) - r.pos} bytes left after the msgpack object")
    return _unchunk(tree)
