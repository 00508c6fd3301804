"""Data layer: the batching loader, the DTU and analytic-sphere datasets,
image and depth codecs, and the synthetic sphere scene."""
