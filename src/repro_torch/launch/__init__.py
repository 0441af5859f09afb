"""Serving entry points (port of ``repro.launch``; training comes later)."""
