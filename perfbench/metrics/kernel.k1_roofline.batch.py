"""Least time of the traced stretch's flash prefill launches (K1) over
their device time in the trace, %."""

from harness.record import roofline


def read(run):
    return roofline(run, "prefill", "k1")
