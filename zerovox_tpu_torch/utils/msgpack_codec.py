"""flax's msgpack checkpoint format, without msgpack or flax.

The JAX package writes its native checkpoints with
`flax.serialization.msgpack_serialize` and reads them with
`msgpack_restore`. This module writes the same bytes and reads the same
files:

  * maps with str keys, packed in sorted key order (`msgpack_serialize`
    copies the tree with `jax.tree_util.tree_map`, which sorts dict keys),
    or with `sort_keys=False` in their own order (`flax.serialization.
    to_bytes` serializes in place: a dataclass's fields in field order);
    lists; str (fixstr, str8,
    str16, str32), bytes (bin8/16/32), int, float (float64), bool and None
    as msgpack packs them with `use_bin_type=True, strict_types=True`;
  * each numpy array as ExtType 1 whose payload is the msgpack array
    (shape, dtype name, C-order bytes);
  * each numpy scalar as ExtType 3, the same payload of its 0-d array, read
    back as a numpy scalar.

Arrays come back as read-only views of the file's bytes, as flax's do.
flax splits arrays above 2**30 bytes into chunks; reading those is not
supported and raises. Tuples are refused, as flax's packer refuses them
(`strict_types`).
"""

from __future__ import annotations

import struct

import numpy as np

EXT_NDARRAY = 1
EXT_NPSCALAR = 3
_CHUNKED = "__msgpack_chunked_array__"


# ------------------------------------------------------------------ writing


def _pack_int(n: int, out: bytearray) -> None:
    if 0 <= n < 0x80:
        out.append(n)
    elif -0x20 <= n < 0:
        out += struct.pack("b", n)
    elif 0x80 <= n <= 0xFF:
        out += b"\xcc" + struct.pack("B", n)
    elif -0x80 <= n < 0:
        out += b"\xd0" + struct.pack("b", n)
    elif 0xFF < n <= 0xFFFF:
        out += b"\xcd" + struct.pack(">H", n)
    elif -0x8000 <= n < -0x80:
        out += b"\xd1" + struct.pack(">h", n)
    elif 0xFFFF < n <= 0xFFFFFFFF:
        out += b"\xce" + struct.pack(">I", n)
    elif -0x80000000 <= n < -0x8000:
        out += b"\xd2" + struct.pack(">i", n)
    elif 0xFFFFFFFF < n <= 0xFFFFFFFFFFFFFFFF:
        out += b"\xcf" + struct.pack(">Q", n)
    elif -0x8000000000000000 <= n < -0x80000000:
        out += b"\xd3" + struct.pack(">q", n)
    else:
        raise OverflowError(f"integer {n} does not fit msgpack's 64 bits")


def _pack_len(n: int, out: bytearray, fix: int | None, fix_max: int, heads: tuple) -> None:
    """A length header: fix | n below fix_max, else the 8/16/32-bit head
    (heads[0] is None where the format has no 8-bit form)."""
    if fix is not None and n < fix_max:
        out.append(fix | n)
    elif heads[0] is not None and n <= 0xFF:
        out += bytes((heads[0], n))
    elif n <= 0xFFFF:
        out += bytes((heads[1],)) + struct.pack(">H", n)
    elif n <= 0xFFFFFFFF:
        out += bytes((heads[2],)) + struct.pack(">I", n)
    else:
        raise ValueError(f"msgpack object of {n} entries or bytes is too large")


def _pack_ext(code: int, data: bytes, out: bytearray) -> None:
    n = len(data)
    fixext = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixext:
        out.append(fixext[n])
    else:
        _pack_len(n, out, None, 0, (0xC7, 0xC8, 0xC9))
    out += struct.pack("b", code) + data


def _ndarray_payload(arr: np.ndarray) -> bytes:
    """flax's `_ndarray_to_bytes`: msgpack of (shape, dtype name, C bytes)."""
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError("object and structured dtypes are not supported")
    return packb([list(arr.shape), arr.dtype.name, arr.tobytes("C")])


def _pack(obj, out: bytearray, sort_keys: bool = True) -> None:
    t = type(obj)
    if obj is None:
        out.append(0xC0)
    elif t is bool:
        out.append(0xC3 if obj else 0xC2)
    elif t is int:
        _pack_int(obj, out)
    elif t is float:
        out += b"\xcb" + struct.pack(">d", obj)
    elif t is str:
        data = obj.encode("utf-8")
        _pack_len(len(data), out, 0xA0, 32, (0xD9, 0xDA, 0xDB))
        out += data
    elif t in (bytes, bytearray, memoryview):
        data = bytes(obj)
        _pack_len(len(data), out, None, 0, (0xC4, 0xC5, 0xC6))
        out += data
    elif t is dict:
        _pack_len(len(obj), out, 0x80, 16, (None, 0xDE, 0xDF))
        for k in sorted(obj) if sort_keys else obj:
            _pack(k, out)
            _pack(obj[k], out, sort_keys)
    elif t is list:
        _pack_len(len(obj), out, 0x90, 16, (None, 0xDC, 0xDD))
        for v in obj:
            _pack(v, out, sort_keys)
    elif isinstance(obj, np.ndarray):
        if obj.nbytes > 2**30:
            raise ValueError(f"array of {obj.nbytes} bytes: flax would chunk it, which is not supported")
        _pack_ext(EXT_NDARRAY, _ndarray_payload(obj), out)
    elif isinstance(obj, np.generic):
        _pack_ext(EXT_NPSCALAR, _ndarray_payload(np.asarray(obj)), out)
    else:
        raise TypeError(f"cannot serialize {t.__name__} in flax's msgpack format")


def packb(tree, sort_keys: bool = True) -> bytes:
    """The bytes `flax.serialization.msgpack_serialize(tree)` gives for a
    tree of dicts, lists, scalars and numpy arrays of at most 2**30 bytes;
    with `sort_keys=False` those of `msgpack_serialize(tree, in_place=True)`,
    which `flax.serialization.to_bytes` writes, maps in their own order."""
    out = bytearray()
    _pack(tree, out, sort_keys)
    return bytes(out)


# ------------------------------------------------------------------ reading


class _Reader:
    def __init__(self, data: bytes, raw: bool):
        self.buf = memoryview(data)
        self.pos = 0
        self.raw = raw  # str as bytes (flax reads the ndarray payload so)

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("truncated msgpack data")
        view = self.buf[self.pos:self.pos + n]
        self.pos += n
        return view

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def string(self, n: int):
        data = bytes(self.take(n))
        return data if self.raw else data.decode("utf-8")

    def read(self):
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.read() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return self.string(b & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        numbers = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                   0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q", 0xCA: ">f", 0xCB: ">d"}
        if b in numbers:
            return self.unpack(numbers[b])
        lens = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I", 0xD9: ">B", 0xDA: ">H", 0xDB: ">I",
                0xDC: ">H", 0xDD: ">I", 0xDE: ">H", 0xDF: ">I", 0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if b in fixext:
            return self.ext(fixext[b])
        if b not in lens:
            raise ValueError(f"unknown msgpack type byte 0x{b:02x}")
        n = self.unpack(lens[b])
        if b <= 0xC6:
            return bytes(self.take(n))
        if b <= 0xC9:
            return self.ext(n)
        if b <= 0xDB:
            return self.string(n)
        if b <= 0xDD:
            return [self.read() for _ in range(n)]
        return self.map(n)

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.read()
            if not isinstance(k, (str, bytes)):
                raise ValueError(f"msgpack map key of type {type(k).__name__}")
            out[k] = self.read()
        if _CHUNKED in out:
            raise ValueError("the checkpoint holds an array flax split into chunks (over 2**30 "
                             "bytes); chunked arrays are not supported")
        return out

    def ext(self, n: int):
        code = self.unpack("b")
        data = bytes(self.take(n))
        if code not in (EXT_NDARRAY, EXT_NPSCALAR):
            raise ValueError(f"unsupported msgpack extension type {code}")
        shape, dtype_name, buffer = _Reader(data, raw=True).read()
        if dtype_name == b"bfloat16":
            raise ValueError("bfloat16 arrays are not supported (numpy has no bfloat16)")
        arr = np.frombuffer(buffer, dtype=np.dtype(dtype_name.decode())).reshape(shape)
        return arr[()] if code == EXT_NPSCALAR else arr


def unpackb(data: bytes):
    """The tree `flax.serialization.msgpack_restore(data)` gives."""
    reader = _Reader(data, raw=False)
    tree = reader.read()
    if reader.pos != len(reader.buf):
        raise ValueError(f"{len(reader.buf) - reader.pos} bytes of trailing data after the tree")
    return tree
