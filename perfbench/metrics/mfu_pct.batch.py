"""The plain model's FLOPs for the windows the traced passes computed
(padded batch slots not counted), over the slice's time and the card's bf16
peak."""
from perfbench.metrics_common import mfu_pct as read  # noqa: F401
