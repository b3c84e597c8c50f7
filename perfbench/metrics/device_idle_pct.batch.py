"""Share of the traced slice of directory passes in which no operation ran
on the card."""
from perfbench.metrics_common import idle_pct as read  # noqa: F401
