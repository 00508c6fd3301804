"""The conditioned field (PixelNeRF), its encoded scene context, and the
NOVEL / NOVEL_PE variants (``models/novel/``)."""
