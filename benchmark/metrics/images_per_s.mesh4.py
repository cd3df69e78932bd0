"""images_per_s of the four-card cell, read by images_per_s's own
reader (images_per_s.py), under a name of its own so that its bound
fits the mesh's spread and images_per_s's fits the one-card cells'."""

from benchmark import spec

read = spec.metric("images_per_s").read
