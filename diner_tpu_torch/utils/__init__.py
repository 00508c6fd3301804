"""Weight bridges from the JAX package's variable trees, resizing, metric
meters and visualization helpers."""
