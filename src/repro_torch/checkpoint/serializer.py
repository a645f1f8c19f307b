"""Tree <-> bytes: msgpack framing + zstd compression + content hash.

Layout: a msgpack map {path: {dtype, shape, data}} with an integrity footer,
the wire format of ``repro.checkpoint.serializer`` byte for byte, so a
checkpoint written by either package restores in the other.  bfloat16 has
no numpy wire type, so it travels as uint16 bit patterns with dtype tag
'bfloat16'.

Leaf paths are the reference's: dict keys as ``str(key)`` (sorted, as the
reference walks them), sequence items as ``str(index)``, ``NamedTuple``
fields (a ``Store``) as ``.<field>``, joined by ``/`` — a ``{kg: Store}``
tree writes ``kg/.keys``, ``kg/.values``, ...

The msgpack codec is built in (``pack``/``unpack``): it covers the subset
the serializer writes — maps with str keys, str, bin, non-negative ints
and arrays — and writes exactly the bytes ``msgpack.packb(obj,
use_bin_type=True)`` writes for it, so the port imports where ``msgpack``
is not installed.

``zstandard`` is optional: environments without it fall back to stdlib
``zlib``.  Decompression sniffs the frame magic so either side can read
blobs produced by the other (zstd frames start with 28 B5 2F FD).
"""
from __future__ import annotations

import hashlib
import struct
import zlib
from typing import Any, Dict, Iterator, List, Tuple

import numpy as np
import torch

from repro_torch.core.tree import tree_flatten, tree_unflatten

try:
    import zstandard
except ModuleNotFoundError:          # degrade gracefully to stdlib zlib
    zstandard = None

_ZSTD_MAGIC = b"\x28\xb5\x2f\xfd"


# ---------------------------------------------------------------------------
# msgpack, the subset the serializer writes
# ---------------------------------------------------------------------------

def _pack_len(out: List[bytes], n: int, fix_base: int, fix_max: int,
              codes: Tuple[int, int, int]) -> None:
    """A container or string header: the fix form when ``n`` fits, else
    the 8-bit (where the type has one), 16-bit or 32-bit length form."""
    c8, c16, c32 = codes
    if n <= fix_max:
        out.append(bytes((fix_base | n,)))
    elif c8 and n <= 0xFF:
        out.append(struct.pack(">BB", c8, n))
    elif n <= 0xFFFF:
        out.append(struct.pack(">BH", c16, n))
    elif n <= 0xFFFFFFFF:
        out.append(struct.pack(">BI", c32, n))
    else:
        raise ValueError(f"msgpack: length {n} does not fit 32 bits")


def _pack_into(out: List[bytes], obj: Any) -> None:
    if isinstance(obj, bool):
        raise TypeError("msgpack: bool is outside the supported subset")
    if isinstance(obj, int):
        if obj < 0:
            raise ValueError("msgpack: negative ints are outside the subset")
        if obj <= 0x7F:
            out.append(bytes((obj,)))
        elif obj <= 0xFF:
            out.append(struct.pack(">BB", 0xCC, obj))
        elif obj <= 0xFFFF:
            out.append(struct.pack(">BH", 0xCD, obj))
        elif obj <= 0xFFFFFFFF:
            out.append(struct.pack(">BI", 0xCE, obj))
        elif obj <= 0xFFFFFFFFFFFFFFFF:
            out.append(struct.pack(">BQ", 0xCF, obj))
        else:
            raise ValueError(f"msgpack: int {obj} does not fit 64 bits")
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        _pack_len(out, len(data), 0xA0, 31, (0xD9, 0xDA, 0xDB))
        out.append(data)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        data = bytes(obj)
        _pack_len(out, len(data), 0, -1, (0xC4, 0xC5, 0xC6))
        out.append(data)
    elif isinstance(obj, dict):
        _pack_len(out, len(obj), 0x80, 15, (0, 0xDE, 0xDF))
        for k, v in obj.items():
            if not isinstance(k, str):
                raise TypeError("msgpack: map keys must be str")
            _pack_into(out, k)
            _pack_into(out, v)
    elif isinstance(obj, (list, tuple)):
        _pack_len(out, len(obj), 0x90, 15, (0, 0xDC, 0xDD))
        for v in obj:
            _pack_into(out, v)
    else:
        raise TypeError(f"msgpack: {type(obj).__name__} is outside the "
                        "supported subset")


def pack(obj: Any) -> bytes:
    """``msgpack.packb(obj, use_bin_type=True)`` for the subset: maps with
    str keys, str, bytes, non-negative ints, lists and tuples."""
    out: List[bytes] = []
    _pack_into(out, obj)
    return b"".join(out)


_FIXED = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q"}
_LENS = {0xD9: ("str", ">B"), 0xDA: ("str", ">H"), 0xDB: ("str", ">I"),
         0xC4: ("bin", ">B"), 0xC5: ("bin", ">H"), 0xC6: ("bin", ">I"),
         0xDE: ("map", ">H"), 0xDF: ("map", ">I"),
         0xDC: ("array", ">H"), 0xDD: ("array", ">I")}


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > len(self.data):
            raise ValueError("msgpack: truncated input")
        out = self.data[self.pos:end]
        self.pos = end
        return out

    def number(self, fmt: str) -> int:
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def read(self) -> Any:
        code = self.take(1)[0]
        if code <= 0x7F:
            return code
        if 0x80 <= code <= 0x8F:
            kind, n = "map", code & 0x0F
        elif 0x90 <= code <= 0x9F:
            kind, n = "array", code & 0x0F
        elif 0xA0 <= code <= 0xBF:
            kind, n = "str", code & 0x1F
        elif code in _FIXED:
            return self.number(_FIXED[code])
        elif code in _LENS:
            kind, fmt = _LENS[code]
            n = self.number(fmt)
        else:
            raise ValueError(f"msgpack: type byte 0x{code:02x} is outside "
                             "the supported subset")
        if kind == "str":
            return str(self.take(n), "utf-8")
        if kind == "bin":
            return bytes(self.take(n))
        if kind == "array":
            return [self.read() for _ in range(n)]
        out = {}
        for _ in range(n):
            k = self.read()
            out[k] = self.read()
        return out


def unpack(data: bytes) -> Any:
    """``msgpack.unpackb(data, raw=False)`` for the subset ``pack`` writes."""
    r = _Reader(data)
    obj = r.read()
    if r.pos != len(r.data):
        raise ValueError("msgpack: extra bytes after the object")
    return obj


# ---------------------------------------------------------------------------
# compression
# ---------------------------------------------------------------------------

def compress_bytes(data: bytes, level: int = 3) -> bytes:
    """zstd when available, zlib otherwise (same framing either way).
    zstd levels go to 22; clamp for zlib's 0..9 range."""
    if zstandard is not None:
        return zstandard.ZstdCompressor(level=level).compress(data)
    return zlib.compress(data, min(level, 9))


def decompress_bytes(blob: bytes) -> bytes:
    """Inverse of ``compress_bytes``; raises ``IOError`` on a corrupted blob
    (a corrupted magic falls through to the zlib branch, a truncated frame
    fails inside either decompressor — both are checkpoint corruption)."""
    if blob[:4] == _ZSTD_MAGIC:
        if zstandard is None:
            raise IOError("blob is zstd-compressed but zstandard is not "
                          "installed; re-save with zlib or install zstandard")
        try:
            return zstandard.ZstdDecompressor().decompress(blob)
        except Exception as e:
            raise IOError(f"checkpoint blob corrupted: zstd frame failed to "
                          f"decompress ({e})") from e
    try:
        return zlib.decompress(blob)
    except zlib.error as e:
        raise IOError(f"checkpoint blob corrupted: not a valid zstd or zlib "
                      f"frame ({e})") from e


# ---------------------------------------------------------------------------
# trees
# ---------------------------------------------------------------------------

def _leaves_with_paths(tree: Any, path: Tuple[str, ...] = ()
                       ) -> Iterator[Tuple[str, Any]]:
    """``(path, leaf)`` in the reference's walk order: dict keys sorted,
    ``NamedTuple`` fields as ``.<name>``, sequence items by index."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves_with_paths(tree[k], path + (str(k),))
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for name, v in zip(tree._fields, tree):
            yield from _leaves_with_paths(v, path + (f".{name}",))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves_with_paths(v, path + (str(i),))
    else:
        yield "/".join(path), tree


def _encode_leaf(x) -> Dict[str, Any]:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            return {"dtype": "bfloat16", "shape": list(x.shape),
                    "data": x.view(torch.int16).numpy().view(
                        np.uint16).tobytes()}
        arr = x.numpy()
    else:
        arr = np.asarray(x)
    return {"dtype": arr.dtype.str, "shape": list(arr.shape),
            "data": arr.tobytes()}


def _decode_leaf(rec: Dict[str, Any]) -> torch.Tensor:
    """A host tensor of the record (``np.frombuffer`` is read-only, so the
    bytes are copied before torch takes them)."""
    shape = tuple(rec["shape"])
    if rec["dtype"] == "bfloat16":
        bits = np.frombuffer(rec["data"], np.uint16).reshape(shape).copy()
        return torch.from_numpy(bits.view(np.int16)).view(torch.bfloat16)
    arr = np.frombuffer(rec["data"], np.dtype(rec["dtype"]))
    return torch.from_numpy(arr.reshape(shape).copy())


def serialize_tree(tree: Any, level: int = 3) -> bytes:
    flat: Dict[str, Any] = {}
    for path, leaf in _leaves_with_paths(tree):
        flat.setdefault(path, _encode_leaf(leaf))
    raw = pack(flat)
    digest = hashlib.sha256(raw).hexdigest().encode()
    framed = pack({"payload": raw, "sha256": digest})
    return compress_bytes(framed, level)


def deserialize_tree(blob: bytes, template: Any) -> Any:
    """The tree of ``template``'s structure, each leaf decoded from
    ``blob`` and placed on the device and in the dtype of the template's
    tensor leaf there; ``ValueError`` on a shape mismatch, ``IOError`` on
    a corrupted blob, ``KeyError`` on a path the blob lacks."""
    try:
        framed = unpack(decompress_bytes(blob))
    except ValueError as e:
        raise IOError(f"checkpoint blob corrupted: {e}") from e
    raw = framed["payload"]
    if hashlib.sha256(raw).hexdigest().encode() != framed["sha256"]:
        raise IOError("checkpoint integrity check failed (sha256 mismatch)")
    flat = unpack(raw)

    def restore(path, leaf):
        t = _decode_leaf(flat[path])
        if tuple(t.shape) != tuple(leaf.shape):
            raise ValueError(f"shape mismatch at {path}: "
                             f"{tuple(t.shape)} vs {tuple(leaf.shape)}")
        return t.to(device=leaf.device, dtype=leaf.dtype)

    # tree_flatten walks in the same order as _leaves_with_paths
    _, treedef = tree_flatten(template)
    return tree_unflatten(treedef, [restore(path, leaf) for path, leaf
                                    in _leaves_with_paths(template)])
