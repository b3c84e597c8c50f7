"""The backbone's share of the card's busy time in the traced slice: the
busy time inside ``ayt.model.backbone``'s device twins over the slice's."""
from perfbench.model_spans import backbone_busy_pct as read  # noqa: F401
