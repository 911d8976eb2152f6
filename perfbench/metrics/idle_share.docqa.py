"""Share of the window in which the device waits, outside the traced
slice: :func:`harness.readers.idle_share`."""

from harness.readers import idle_share


def read(record):
    return idle_share(record)
