"""Milliseconds of the card's busy time inside the backbone's span
(``ayt.model.backbone``'s device twins) per device batch."""
from perfbench.model_spans import backbone_ms as read  # noqa: F401
