"""device_idle_pct.predict in the ViT's cell, by its own reader, under a
name of the ViT's own: the card's share of the traced slice (chr1-3) in
which no device operation runs, in %."""

from benchmark import spec

read = spec.metric("device_idle_pct.predict").read
