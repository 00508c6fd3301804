"""Synthetic scenes for tests and the chip smoke run."""
