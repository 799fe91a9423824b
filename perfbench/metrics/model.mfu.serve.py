"""The window's model operations (harness.work) over the wall time
inside ServingEngine.step() at the bf16 peak, %."""

from harness.record import mfu as read  # noqa: F401
