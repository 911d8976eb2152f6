"""Tensor wire protocol (port of ``repro/wire/codec.py``), byte-compatible.

Frame layout (little-endian)::

    u32  magic        0x52505257  ("RPRW")
    u8   version      1
    u8   dtype_code   (see DTYPE_CODES)
    u16  rank
    u64  dim[rank]
    u8   payload[prod(dims) * itemsize]   (C-order raw values)
    u32  crc32(payload)

A *pytree frame* is a JSON header frame (dtype_code=255 carrying UTF-8) with
the structure + leaf count, followed by one tensor frame per leaf, leaves in
``jax.tree.leaves`` order (dicts by sorted key).  A frame or pytree written
by either package decodes in the other.

Leaves may be torch tensors (any device; copied to the host), numpy arrays
(a numpy ``bfloat16`` array from the reference crosses by its name, no
import needed) or Python scalars.  Decoding gives CPU torch tensors; bf16
travels as its uint16 bit pattern both ways, so no value is rounded.
Payloads are written and checked from the tensor's own memory, not from a
``bytes`` copy, so a multi-GB checkpoint is not copied once more.
"""

from __future__ import annotations

import io
import json
import math
import struct
import zlib
from typing import Any, BinaryIO

import numpy as np
import torch

MAGIC = 0x52505257
VERSION = 1

# dtype_code -> dtype (the reference's table); bf16 is its uint16 bit pattern
DTYPE_CODES = {
    0: torch.float32,
    1: torch.float64,
    2: torch.float16,
    3: torch.int8,
    4: torch.int16,
    5: torch.int32,
    6: torch.int64,
    7: torch.uint8,
    8: torch.uint16,
    9: torch.uint32,
    10: torch.uint64,
    11: torch.bool,
    12: torch.bfloat16,
    255: None,       # JSON header frame
}
_CODE_FOR = {dt: c for c, dt in DTYPE_CODES.items() if dt is not None}
_BF16_CODE = 12
_JSON_CODE = 255

_HDR = struct.Struct("<IBBH")  # magic, version, dtype_code, rank
MAX_RANK = 64                  # torch's own limit on a tensor's dimensions
_CHUNK = 1 << 24               # read size of a header or of an unseekable payload


class WireError(ValueError):
    pass


def _as_tensor(leaf: Any) -> torch.Tensor:
    """A contiguous CPU tensor of the leaf's values (a view where possible)."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().contiguous()
    arr = np.asarray(leaf)
    if not arr.flags.c_contiguous:
        arr = arr.copy(order="C")
    if arr.dtype.name == "bfloat16":                 # ml_dtypes, from the reference
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    try:
        return torch.from_numpy(arr)
    except TypeError:
        raise WireError(f"unsupported dtype {arr.dtype}") from None


def _payload(t: torch.Tensor) -> memoryview:
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return memoryview(t.reshape(-1).numpy().view(np.uint8))


def encode_tensor(arr: Any, out: BinaryIO) -> int:
    """Encode one tensor or array as a wire frame. Returns bytes written."""
    t = _as_tensor(arr)
    try:
        code = _CODE_FOR[t.dtype]
    except KeyError:
        raise WireError(f"unsupported dtype {t.dtype}") from None
    payload = _payload(t)
    n = out.write(_HDR.pack(MAGIC, VERSION, code, t.dim()))
    n += out.write(struct.pack(f"<{t.dim()}Q", *t.shape))
    n += out.write(payload)
    n += out.write(struct.pack("<I", zlib.crc32(payload) & 0xFFFFFFFF))
    return n


def _read_exact(src: BinaryIO, n: int) -> bytearray:
    """``n`` bytes of ``src``, read in chunks as they arrive, so a corrupt
    length cannot allocate more than the stream holds."""
    buf = bytearray()
    while len(buf) < n:
        part = src.read(min(n - len(buf), _CHUNK))
        if not part:
            break
        buf += part
    if len(buf) != n:
        raise WireError(f"truncated frame: wanted {n} bytes, got {len(buf)}")
    return buf


def _read_payload(src: BinaryIO, n: int) -> np.ndarray:
    """``n`` payload bytes as a writable uint8 array: read straight into it
    where the stream can say how many bytes it holds (a multi-GB checkpoint
    is not copied once more), else in chunks."""
    if not (hasattr(src, "seekable") and src.seekable()):
        return np.frombuffer(_read_exact(src, n), np.uint8)
    pos = src.tell()
    left = src.seek(0, io.SEEK_END) - pos
    src.seek(pos)
    if n > left:
        raise WireError(f"payload of {n} bytes exceeds the {left} bytes left")
    buf = np.empty(max(n, 1), np.uint8)[:n]
    got = src.readinto(memoryview(buf))
    if got != n:
        raise WireError(f"truncated frame: wanted {n} bytes, got {got}")
    return buf


def _read_header(src: BinaryIO) -> tuple[int, int, tuple[int, ...]]:
    """The checked magic, version and rank of a frame: (code, rank, shape)."""
    magic, version, code, rank = _HDR.unpack(_read_exact(src, _HDR.size))
    if magic != MAGIC:
        raise WireError(f"bad magic {magic:#x}")
    if version != VERSION:
        raise WireError(f"unsupported version {version}")
    if rank > MAX_RANK:
        raise WireError(f"rank {rank} exceeds {MAX_RANK}")
    shape = struct.unpack(f"<{rank}Q", _read_exact(src, 8 * rank)) if rank else ()
    return code, rank, shape


def decode_tensor(src: BinaryIO) -> torch.Tensor:
    code, _, shape = _read_header(src)
    if code == _JSON_CODE:
        raise WireError("unexpected JSON frame; use decode_pytree")
    try:
        dtype = DTYPE_CODES[code]
    except KeyError:
        raise WireError(f"unknown dtype code {code}") from None
    buf = _read_payload(src, math.prod(shape) * dtype.itemsize)
    (crc,) = struct.unpack("<I", _read_exact(src, 4))
    if crc != (zlib.crc32(memoryview(buf)) & 0xFFFFFFFF):
        raise WireError("payload CRC mismatch")
    if code == _BF16_CODE:
        return torch.from_numpy(buf.view(np.int16)).view(torch.bfloat16).reshape(shape)
    return torch.from_numpy(buf).view(dtype).reshape(shape)


def _encode_json(obj: Any, out: BinaryIO) -> int:
    payload = json.dumps(obj, sort_keys=True).encode("utf-8")
    n = out.write(_HDR.pack(MAGIC, VERSION, _JSON_CODE, 1))
    n += out.write(struct.pack("<1Q", len(payload)))
    n += out.write(payload)
    n += out.write(struct.pack("<I", zlib.crc32(payload) & 0xFFFFFFFF))
    return n


def _decode_json(src: BinaryIO) -> Any:
    code, rank, shape = _read_header(src)
    if code != _JSON_CODE or rank != 1:
        raise WireError("expected JSON frame")
    (length,) = shape
    payload = _read_exact(src, length)
    (crc,) = struct.unpack("<I", _read_exact(src, 4))
    if crc != (zlib.crc32(payload) & 0xFFFFFFFF):
        raise WireError("JSON CRC mismatch")
    return json.loads(payload.decode("utf-8"))


# --- trees of dicts, lists, tuples and None --------------------------------
def _structure(tree: Any, out_leaves: list) -> Any:
    """The reference's JSON structure of ``tree``; appends its leaves."""
    if tree is None:
        return {"t": "none"}
    if isinstance(tree, dict):
        keys = sorted(tree)
        return {"t": "dict", "k": keys, "v": [_structure(tree[k], out_leaves) for k in keys]}
    if isinstance(tree, (tuple, list)):
        return {"t": type(tree).__name__, "v": [_structure(x, out_leaves) for x in tree]}
    out_leaves.append(tree)
    return {"t": "leaf"}


def _rebuild(spec: Any, it) -> Any:
    t = spec["t"]
    if t == "leaf":
        return next(it)
    if t == "none":
        return None
    if t == "dict":
        return {k: _rebuild(v, it) for k, v in zip(spec["k"], spec["v"])}
    if t == "tuple":
        return tuple(_rebuild(v, it) for v in spec["v"])
    if t == "list":
        return [_rebuild(v, it) for v in spec["v"]]
    raise WireError(f"bad structure spec {t}")


def encode_pytree(tree: Any, out: BinaryIO) -> int:
    """Encode a tree of dicts/lists/tuples/None over tensors, arrays and
    Python scalars."""
    flat: list = []
    header = {"treedef": _structure(tree, flat)}
    header["n_leaves"] = len(flat)
    n = _encode_json(header, out)
    for leaf in flat:
        n += encode_tensor(leaf, out)
    return n


def decode_pytree(src: BinaryIO) -> Any:
    header = _decode_json(src)
    leaves = [decode_tensor(src) for _ in range(header["n_leaves"])]
    return _rebuild(header["treedef"], iter(leaves))


def dumps(tree: Any) -> bytes:
    buf = io.BytesIO()
    encode_pytree(tree, buf)
    return buf.getvalue()


def loads(data: bytes) -> Any:
    """Decode one pytree that fills ``data``; trailing bytes are an error."""
    src = io.BytesIO(data)
    tree = decode_pytree(src)
    if src.tell() != len(data):
        raise WireError(f"{len(data) - src.tell()} trailing bytes after the pytree")
    return tree
