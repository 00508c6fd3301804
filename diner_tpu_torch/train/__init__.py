"""Model construction and the eval step (training comes later)."""
