"""Tree checkpoints in the reference's msgpack layout, with a pure-Python
codec (mirrors ``repro/checkpoint/msgpack_ckpt.py``; no ``msgpack``
package needed).

A leaf is the map ``{"__leaf__": true, "dtype", "shape", "data"}`` with the
raw little-endian bytes as a bin blob; a list or tuple is ``{"__seq__":
[...], "__tuple__": bool}``; a dict is a map.  The encoder emits the bytes
``msgpack.packb(_pack(tree), use_bin_type=True)`` gives for the same tree
(maps in insertion order, the smallest int, str and bin headers), so each
package reads the other's files (`tests/test_torch_checkpoint.py`).
``bfloat16`` leaves cross as their raw 2-byte words.  The codec covers what
``_pack`` emits: maps, arrays, str, bin 8/16/32, bool, int, float and nil;
a bin blob holds at most 4 GiB, and a larger leaf raises.

``load_pytree`` returns CPU tensors; ``save_pytree`` writes ``path.tmp``
and renames it over ``path``.
"""
from __future__ import annotations

import os
import struct

import numpy as np
import torch

_LEAF = "__leaf__"
_BIN_MAX = 0xFFFFFFFF

DTYPES = {"float64": torch.float64, "float32": torch.float32,
          "float16": torch.float16, "bfloat16": torch.bfloat16,
          "int64": torch.int64, "int32": torch.int32, "int16": torch.int16,
          "int8": torch.int8, "uint8": torch.uint8, "bool": torch.bool}


# ------------------------------------------------------------------ leaves --
def _leaf(x):
    """(dtype name, shape, raw bytes as a buffer) of a tensor, an array or
    a number."""
    if isinstance(x, torch.Tensor):
        t = x.detach().to("cpu").contiguous()
        name = str(t.dtype).removeprefix("torch.")
        if name not in DTYPES:
            raise ValueError(f"cannot checkpoint a {t.dtype} leaf")
        raw = t.reshape(-1).view(torch.uint8).numpy()
        return name, list(t.shape), memoryview(raw)
    arr = np.asarray(x)
    if not arr.flags.c_contiguous:      # (ascontiguousarray would make 0-d 1-d)
        arr = arr.copy(order="C")
    return str(arr.dtype), list(arr.shape), memoryview(
        arr.reshape(-1).view(np.uint8))


def _pack(tree):
    if isinstance(tree, dict):
        return {str(k): _pack(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return {"__seq__": [_pack(v) for v in tree],
                "__tuple__": isinstance(tree, tuple)}
    dtype, shape, data = _leaf(tree)
    return {_LEAF: True, "dtype": dtype, "shape": shape, "data": data}


def _tensor(node) -> torch.Tensor:
    name, shape = node["dtype"], tuple(node["shape"])
    if name not in DTYPES:
        raise ValueError(f"checkpoint leaf of dtype {name!r} is not supported")
    out = torch.empty(shape, dtype=DTYPES[name])
    if out.numel():
        # a fresh, aligned tensor: the blob may start at any byte offset
        out.reshape(-1).view(torch.uint8).copy_(
            torch.frombuffer(node["data"], dtype=torch.uint8))
    return out


def _unpack(node):
    if isinstance(node, dict) and node.get(_LEAF):
        return _tensor(node)
    if isinstance(node, dict) and "__seq__" in node:
        seq = [_unpack(v) for v in node["__seq__"]]
        return tuple(seq) if node.get("__tuple__") else seq
    return {k: _unpack(v) for k, v in node.items()}


# ------------------------------------------------------------------- codec --
def _int(x: int) -> bytes:
    if x < -(1 << 5):
        if x < -(1 << 15):
            return (b"\xd3" + struct.pack(">q", x) if x < -(1 << 31)
                    else b"\xd2" + struct.pack(">i", x))
        return (b"\xd1" + struct.pack(">h", x) if x < -(1 << 7)
                else b"\xd0" + struct.pack(">b", x))
    if x < (1 << 7):
        return struct.pack(">b", x)                      # fixint, +/-
    if x < (1 << 16):
        return (b"\xcc" + struct.pack(">B", x) if x < (1 << 8)
                else b"\xcd" + struct.pack(">H", x))
    if x < (1 << 64):
        return (b"\xce" + struct.pack(">I", x) if x < (1 << 32)
                else b"\xcf" + struct.pack(">Q", x))
    raise ValueError(f"int {x} does not fit msgpack's 64 bits")


def _header(n: int, fix: int, fix_max: int, codes: tuple, what: str
            ) -> bytes:
    """A length header: the fix form below ``fix_max``, else the first of
    the 8/16/32-bit forms in ``codes`` (``None`` where msgpack has none)
    that holds n."""
    if fix is not None and n < fix_max:
        return bytes([fix | n])
    for code, fmt, limit in zip(codes, (">B", ">H", ">I"),
                                (1 << 8, 1 << 16, 1 << 32)):
        if code is not None and n < limit:
            return bytes([code]) + struct.pack(fmt, n)
    raise ValueError(f"{what} of {n} entries or bytes does not fit msgpack")


def encode(obj, out: list) -> None:
    """Append ``obj``'s msgpack encoding to ``out`` as pieces (bin blobs are
    appended as the buffers themselves, not copied)."""
    if obj is None:
        out.append(b"\xc0")
    elif obj is True or obj is False:
        out.append(b"\xc3" if obj else b"\xc2")
    elif isinstance(obj, int):
        out.append(_int(obj))
    elif isinstance(obj, float):
        out.append(b"\xcb" + struct.pack(">d", obj))
    elif isinstance(obj, str):
        b = obj.encode()
        out.append(_header(len(b), 0xA0, 32, (0xD9, 0xDA, 0xDB), "str"))
        out.append(b)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        n = memoryview(obj).nbytes
        if n > _BIN_MAX:
            raise ValueError(f"a leaf of {n} bytes is above msgpack's 4 GiB "
                             f"bin limit")
        out.append(_header(n, None, 0, (0xC4, 0xC5, 0xC6), "bin"))
        out.append(obj)
    elif isinstance(obj, dict):
        out.append(_header(len(obj), 0x80, 16, (None, 0xDE, 0xDF), "map"))
        for k, v in obj.items():
            encode(k, out)
            encode(v, out)
    elif isinstance(obj, (list, tuple)):
        out.append(_header(len(obj), 0x90, 16, (None, 0xDC, 0xDD), "array"))
        for v in obj:
            encode(v, out)
    else:
        raise TypeError(f"cannot msgpack a {type(obj).__name__}")


def packb(obj) -> bytes:
    """``obj``'s msgpack bytes (for tests and small objects)."""
    out: list = []
    encode(obj, out)
    return b"".join(bytes(p) for p in out)


class _Reader:
    def __init__(self, buf):
        self.buf = memoryview(buf)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("truncated msgpack data")
        v = self.buf[self.pos:self.pos + n]
        self.pos += n
        return v

    def unpack(self, fmt: str, n: int):
        return struct.unpack(fmt, self.take(n))[0]

    def obj(self):
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
            return str(self.take(b & 0x1F), "utf-8")
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        if b in (0xC4, 0xC5, 0xC6):
            n = self.unpack((">B", ">H", ">I")[b - 0xC4], 1 << (b - 0xC4))
            return self.take(n)
        if b in (0xD9, 0xDA, 0xDB):
            n = self.unpack((">B", ">H", ">I")[b - 0xD9], 1 << (b - 0xD9))
            return str(self.take(n), "utf-8")
        ints = {0xCC: (">B", 1), 0xCD: (">H", 2), 0xCE: (">I", 4),
                0xCF: (">Q", 8), 0xD0: (">b", 1), 0xD1: (">h", 2),
                0xD2: (">i", 4), 0xD3: (">q", 8), 0xCA: (">f", 4),
                0xCB: (">d", 8)}
        if b in ints:
            return self.unpack(*ints[b])
        if b in (0xDC, 0xDD):
            n = self.unpack(">H" if b == 0xDC else ">I", 2 if b == 0xDC else 4)
            return [self.obj() for _ in range(n)]
        if b in (0xDE, 0xDF):
            n = self.unpack(">H" if b == 0xDE else ">I", 2 if b == 0xDE else 4)
            return self.map(n)
        raise ValueError(f"msgpack type byte 0x{b:02x} is outside the "
                         f"subset checkpoints use")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.obj()
            out[k] = self.obj()
        return out


def unpackb(buf):
    """Decode one msgpack object; bin blobs come back as memoryviews of
    ``buf``."""
    r = _Reader(buf)
    obj = r.obj()
    if r.pos != len(r.buf):
        raise ValueError(f"{len(r.buf) - r.pos} bytes after the msgpack "
                         f"object")
    return obj


# -------------------------------------------------------------------- files --
def save_pytree(path: str, tree) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    pieces: list = []
    encode(_pack(tree), pieces)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        for p in pieces:
            f.write(p)
    os.replace(tmp, path)


def load_pytree(path: str, shardings=None):
    """The tree saved at ``path`` (by either package), leaves as CPU
    tensors.  ``shardings``, a tree matching the file's structure, keeps
    a rank's part of each leaf: where it holds an object with a
    ``local(tensor)`` method (`launch.sharding.RankSlice`) the leaf becomes
    that part (a copy), where it holds None the node stays whole."""
    with open(path, "rb") as f:
        buf = bytearray(os.fstat(f.fileno()).st_size)
        f.readinto(buf)
    tree = _unpack(unpackb(buf))
    return tree if shardings is None else _keep(tree, shardings)


def _keep(tree, shardings):
    if shardings is None:
        return tree
    if isinstance(tree, dict):
        return {k: _keep(v, shardings.get(k)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        if len(tree) != len(shardings):
            raise ValueError(f"the file holds {len(tree)} leaves in a list "
                             f"where the shardings give {len(shardings)}")
        return type(tree)(_keep(v, s) for v, s in zip(tree, shardings))
    return shardings.local(tree).clone()
