"""Milliseconds of stacking and padding windows into a batch
(``ayt.stream.stack``, on the producer thread) per device batch."""
from perfbench.program_spans import stack_ms as read  # noqa: F401
