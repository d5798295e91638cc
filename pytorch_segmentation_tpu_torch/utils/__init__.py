"""Runtime, weights and PNG helpers."""
