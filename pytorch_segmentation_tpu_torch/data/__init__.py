"""Host data: palette, dataset constants, normalization."""
