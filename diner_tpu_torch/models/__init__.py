"""The conditioned field (PixelNeRF) and its encoded scene context."""
