"""Kernel 1 (staging and main pass, by kernel name): the least time its
call's shapes need (``count/mel_kernel.py``) over its device time per
launch."""
from perfbench.metrics_common import kernel1_roofline_pct as read  # noqa: F401
