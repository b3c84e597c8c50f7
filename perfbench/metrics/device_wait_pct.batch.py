"""Share of the traced slice in which the dispatching thread waited for a
batch's results on the card (``ayt.stream.wait_device``)."""
from perfbench.program_spans import device_wait_pct as read  # noqa: F401
