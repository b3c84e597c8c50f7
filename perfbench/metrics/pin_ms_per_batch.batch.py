"""Milliseconds of filling fresh pinned host memory (``ayt.stream.pin``, on
the producer thread) per device batch; the copy's enqueue is left out."""
from perfbench.program_spans import pin_ms as read  # noqa: F401
