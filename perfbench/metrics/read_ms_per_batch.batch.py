"""Milliseconds of window reads (``ayt.stream.read``, on the producer
thread) per device batch of the traced slice."""
from perfbench.program_spans import read_ms as read  # noqa: F401
