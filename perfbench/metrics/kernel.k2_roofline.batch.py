"""Least time of the traced stretch's paged decode launches (K2) over
their device time in the trace, %."""

from harness.record import roofline


def read(run):
    return roofline(run, "decode", "k2")
