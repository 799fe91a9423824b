"""Share of the traced stretch in which no kernel or copy ran on the
card, %."""

from harness.record import idle_share as read  # noqa: F401
