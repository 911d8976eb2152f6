"""Percent of the traced slice's device-idle time whose innermost program
span, at each idle gap's middle, is ``engine.decode``: the device waiting
while the host enqueues a decode step (:func:`harness.program.idle_share_in`).

Read in the traced slice only, where the profiler slows the host: every
host phase takes longer there, so the idle time is larger than outside it;
the share is biased toward the phases whose host work the profiler slows
most, the ones that launch most (this one)."""

from harness.program import idle_share_in


def read(record):
    return idle_share_in(record.trace, ("engine.decode",))
