"""Generated tokens emitted in the window over the window's seconds."""


def read(record):
    h = record.host
    return h["tokens"] / h["window_s"] if "requests" in h and h["window_s"] > 0 else None
