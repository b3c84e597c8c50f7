"""Milliseconds of host work after a batch's fetch (``ayt.stream.drain``,
self time: rows and CSVs) per device batch."""
from perfbench.program_spans import drain_ms as read  # noqa: F401
