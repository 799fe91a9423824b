"""Utilities of the port: profiling windows and spans (``profiling``),
training checkpoints (``checkpoint``) and the shaping TCP relay
(``netshaper``)."""

from .checkpoint import (  # noqa: F401
    latest_step,
    restore_train_state,
    save_train_state,
)
from .profiling import ProfileWindow, Span, profile_window  # noqa: F401
