"""Wall time inside put_kv_pages and conn.sync() over the window, %."""

from harness.record import offload_share as read  # noqa: F401
