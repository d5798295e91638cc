"""Model loading."""
