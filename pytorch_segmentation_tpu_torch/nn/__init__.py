"""Building blocks."""
