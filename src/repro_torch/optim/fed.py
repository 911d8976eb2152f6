"""Federated aggregation: sample-weighted fed-avg over wire-framed updates
(port of ``repro/optim/fed.py``; the frames are byte-equal to the
reference's for the same tree of values, in both directions).

The training plane (:mod:`repro_torch.serving.train_plane`) ships each
participant's local model delta as ONE fed frame per round.  This module
owns both ends of that exchange:

* **Frame codec** — a magic-byte-versioned envelope around the tensor
  wire protocol (:mod:`repro_torch.wire.codec`).  Two modes:

  - ``int8_ef`` — the delta runs through :mod:`repro_torch.optim.compress`
    (per-leaf absmax int8 + error feedback), the ``{"q", "s"}`` tree is
    wire-framed, and the whole tensor stream is DEFLATE-compressed.
  - ``bf16`` — the uncompressed baseline: the delta cast to bfloat16 and
    wire-framed raw.

  Frame layout (little-endian)::

      u8[4]  magic     b"FEDR"
      u8     version   1
      u8     mode      1 = int8_ef (DEFLATE payload), 2 = bf16 (raw)
      u32    raw_len   decompressed payload length (mode 1; 0 for mode 2)
      u8[]   payload   wire-codec pytree stream (per-tensor magic + CRC)

* **Aggregation** — :func:`fed_avg` applies sample-weighted averaging in
  FIXED sorted-participant-name order, so the reduction is bit-
  deterministic regardless of the sim-time order deliveries landed in.

Decoded deltas land on ``device``: the card unless the caller passes
``device="cpu"``, as the package's other entry points (the reference's
arrays land on JAX's default device).  The coordinator passes its model's
device.
"""

from __future__ import annotations

import dataclasses
import struct
import zlib
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.convert import leaves, tree_map, unflatten
from repro_torch.optim import compress
from repro_torch.wire import codec

FED_MAGIC = b"FEDR"
FED_VERSION = 1
MODE_INT8_EF = 1
MODE_BF16 = 2
_HDR = struct.Struct("<4sBBI")   # magic, version, mode, raw_len


class FedWireError(ValueError):
    pass


def encode_update(delta: Any, *, mode: str = "int8_ef",
                  error: Optional[Any] = None,
                  topk_frac: Optional[float] = 0.5) -> Tuple[bytes, Any]:
    """Encode one participant's model delta as a fed frame.

    Returns ``(frame_bytes, new_error_tree)``.  ``error`` is the
    participant's persistent error-feedback state (``int8_ef`` mode only;
    pass the previous round's return value, or None for round zero).
    ``topk_frac`` sparsifies the int8 stream (error feedback carries the
    dropped mass — see :func:`repro_torch.optim.compress.compress_tree`).
    ``bf16`` mode carries no residual — ``new_error`` is returned
    unchanged so callers can thread one code path."""
    if mode == "int8_ef":
        if error is None:
            error = compress.init_error(delta)
        q, s, new_error = compress.compress_tree(delta, error, topk_frac=topk_frac)
        raw = codec.dumps({"q": q, "s": s})
        payload = zlib.compress(raw, 6)
        frame = _HDR.pack(FED_MAGIC, FED_VERSION, MODE_INT8_EF, len(raw)) + payload
        return frame, new_error
    if mode == "bf16":
        payload = codec.dumps(tree_map(lambda x: x.to(torch.bfloat16), delta))
        frame = _HDR.pack(FED_MAGIC, FED_VERSION, MODE_BF16, 0) + payload
        return frame, error
    raise ValueError(f"unknown fed frame mode {mode!r}")


def decode_update(frame: bytes, device="cuda") -> Any:
    """Decode a fed frame back to a float32 delta tree on ``device`` (the
    coordinator aggregates what was actually DELIVERED over the wire —
    dequantised int8 or bf16-rounded values, never the sender's exact
    floats)."""
    if len(frame) < _HDR.size:
        raise FedWireError(f"fed frame truncated at {len(frame)} bytes")
    magic, version, mode, raw_len = _HDR.unpack_from(frame)
    if magic != FED_MAGIC:
        raise FedWireError(f"bad fed magic {magic!r}")
    if version != FED_VERSION:
        raise FedWireError(f"unsupported fed frame version {version}")
    payload = frame[_HDR.size:]
    if mode == MODE_INT8_EF:
        raw = zlib.decompress(payload)
        if len(raw) != raw_len:
            raise FedWireError(f"fed payload length {len(raw)} != header "
                               f"raw_len {raw_len}")
        tree = codec.loads(raw)
        qs = tree_map(lambda x: x.to(device), tree["q"])
        ss = tree_map(lambda x: x.to(device), tree["s"])
        return compress.decompress_tree(qs, ss)
    if mode == MODE_BF16:
        tree = codec.loads(payload)
        return tree_map(lambda x: x.to(device).to(torch.float32), tree)
    raise FedWireError(f"unknown fed frame mode {mode}")


@dataclasses.dataclass(frozen=True)
class ClientUpdate:
    """One delivered participant contribution: who, how many samples the
    delta was computed from, and the frame exactly as it crossed the
    link."""
    name: str
    samples: int
    frame: bytes


def fed_avg(updates: Sequence[ClientUpdate], device="cuda") -> Any:
    """Sample-weighted average of the DELIVERED deltas, reduced in fixed
    sorted-name order (bit-deterministic: delivery order is sim-schedule
    dependent, the reduction must not be).  Returns None when nothing was
    delivered — a fully-failed round applies no update."""
    ups = sorted(updates, key=lambda u: u.name)
    if not ups:
        return None
    names = [u.name for u in ups]
    if len(set(names)) != len(names):
        raise ValueError(f"duplicate participant names in round: {names}")
    total = float(sum(u.samples for u in ups))
    if total <= 0:
        raise ValueError("fed_avg needs a positive total sample count")
    acc = None
    for u in ups:
        delta = decode_update(u.frame, device)
        # the reference's jnp.float32 weight: a Python float that fp32
        # holds exactly, so the product is the fp32 product
        w = float(np.float32(u.samples / total))
        scaled = tree_map(lambda d: d.to(torch.float32) * w, delta)
        acc = scaled if acc is None else unflatten(
            acc, [a + b for a, b in zip(leaves(acc), leaves(scaled))])
    return acc


def apply_update(params: Any, avg_delta: Any) -> Any:
    """``params + avg_delta`` leaf-wise (cast back to each leaf's dtype)."""
    if avg_delta is None:
        return params
    return unflatten(params, [(p.to(torch.float32) + d).to(p.dtype)
                              for p, d in zip(leaves(params), leaves(avg_delta))])


def tree_delta(new: Any, old: Any) -> Any:
    """``new - old`` leaf-wise in float32 (the per-round local delta)."""
    return unflatten(new, [n.to(torch.float32) - o.to(torch.float32)
                           for n, o in zip(leaves(new), leaves(old))])


def frame_sizes(delta: Any) -> Tuple[int, int]:
    """(int8_ef bytes, bf16 bytes) for one encoding of ``delta`` — the
    wire A/B without shipping anything."""
    f_int8, _ = encode_update(delta, mode="int8_ef")
    f_bf16, _ = encode_update(delta, mode="bf16")
    return len(f_int8), len(f_bf16)


__all__: List[str] = [
    "FED_MAGIC", "FED_VERSION", "MODE_INT8_EF", "MODE_BF16", "FedWireError",
    "ClientUpdate", "encode_update", "decode_update", "fed_avg",
    "apply_update", "tree_delta", "frame_sizes",
]
