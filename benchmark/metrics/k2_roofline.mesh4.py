"""k2_roofline.predict in the four-card cell, by its own reader, under a
name that moves images_per_s.mesh4, the mesh's own rate."""

from benchmark import spec

read = spec.metric("k2_roofline.predict").read
