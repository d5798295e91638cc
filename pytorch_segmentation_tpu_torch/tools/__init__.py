"""Measurement tools of the port (run as `python -m ...tools.<name>`)."""
