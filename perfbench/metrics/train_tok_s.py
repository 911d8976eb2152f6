"""Tokens of every training step of the window over the time from the
window's start to the end of the last of them (device synchronised)."""


def read(record):
    h = record.host
    return h["tokens"] / h["window_s"] if "losses" in h and h["window_s"] > 0 else None
