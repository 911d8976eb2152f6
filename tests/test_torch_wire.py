"""The port's wire codec against corrupted frames.

Every byte of the reference's corruption frame (``tests/test_wire.py``) is
set to 0, 32, 255 and to itself xor 1, with the reference test's rule that a
value equal to the byte moves on by one.  Each case must raise ``WireError``
(a corrupted shape must not allocate before the payload is read, a corrupted
version must not decode, trailing bytes must not be ignored), and valid
frames still cross to the reference.
"""

import io

import numpy as np
import pytest

from repro.wire import codec as jcodec
from repro_torch.wire import codec

FRAME = codec.dumps({"a": np.arange(64, dtype=np.float32)})
VALUES = (0, 32, 255, "xor1")


def _corrupt(pos: int, val) -> bytes:
    data = bytearray(FRAME)
    val = data[pos] ^ 1 if val == "xor1" else val
    if data[pos] == val:
        val = (val + 1) % 256
    data[pos] = val
    return bytes(data)


def test_frame_is_the_reference_frame():
    assert len(FRAME) == 371
    assert FRAME == jcodec.dumps({"a": np.arange(64, dtype=np.float32)})


@pytest.mark.parametrize("val", VALUES)
def test_every_corrupted_byte_raises_wire_error(val):
    wrong = []
    for pos in range(len(FRAME)):
        try:
            codec.loads(_corrupt(pos, val))
        except codec.WireError:
            continue
        except Exception as e:  # noqa: BLE001 - the wrong error is the finding
            wrong.append((pos, type(e).__name__))
        else:
            wrong.append((pos, "decoded"))
    assert not wrong, wrong


def test_reference_hypothesis_example_raises_wire_error():
    """pos=110, val=32: a shape byte that makes the count wrap."""
    with pytest.raises(codec.WireError):
        codec.loads(_corrupt(110, 32))


@pytest.mark.parametrize("pos,val,match", [
    (4, 7, "version"),            # the JSON frame's version byte
    (15, 255, "truncated"),       # the JSON length's top byte
    (107, 255, "exceeds"),        # the tensor's shape, far beyond the frame
])
def test_corrupt_headers_name_the_fault(pos, val, match):
    with pytest.raises(codec.WireError, match=match):
        codec.loads(_corrupt(pos, val))


def test_trailing_bytes_raise_but_the_stream_form_reads_one_tree():
    with pytest.raises(codec.WireError, match="trailing"):
        codec.loads(FRAME + b"\0")
    src = io.BytesIO(FRAME + FRAME)
    for _ in range(2):
        np.testing.assert_array_equal(codec.decode_pytree(src)["a"].numpy(),
                                      np.arange(64, dtype=np.float32))


class _Stream(io.RawIOBase):
    """A stream that cannot seek, as a socket is not."""

    def __init__(self, data: bytes):
        self._src = io.BytesIO(data)

    def readable(self):
        return True

    def readinto(self, b):
        return self._src.readinto(b)


def test_unseekable_stream_decodes_and_rejects_a_huge_shape():
    out = codec.decode_pytree(_Stream(FRAME))
    np.testing.assert_array_equal(out["a"].numpy(), np.arange(64, dtype=np.float32))
    with pytest.raises(codec.WireError, match="truncated"):
        codec.decode_pytree(_Stream(_corrupt(108, 255)))
