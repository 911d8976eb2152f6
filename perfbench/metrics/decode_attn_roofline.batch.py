"""Roofline share of the dense-lane decode-attention kernel in the traced
decode steps (live positions counted, not max_len)."""

from harness.readers import decode_share


def read(record):
    return decode_share(record, "Dense")
