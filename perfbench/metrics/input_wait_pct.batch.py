"""Share of the traced slice in which the dispatching thread waited for the
producer thread's next batch (``ayt.stream.wait_input``)."""
from perfbench.program_spans import input_wait_pct as read  # noqa: F401
