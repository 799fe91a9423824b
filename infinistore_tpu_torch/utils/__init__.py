"""Profiling helpers of the port (``utils/checkpoint.py`` is not ported
yet)."""

from .profiling import ProfileWindow, profile_window  # noqa: F401
