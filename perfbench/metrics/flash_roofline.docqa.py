"""Roofline share of the flash kernel in the traced prefill dispatches."""

from harness.readers import flash_share


def read(record):
    return flash_share(record)
