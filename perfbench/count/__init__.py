"""Frozen counts: peaks of the card, the plain model's FLOPs, kernel 1's
operations and bytes. Computed from shapes, never from the measured program."""
