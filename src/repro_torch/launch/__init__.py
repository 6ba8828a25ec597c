"""Drivers (``repro.launch``): so far ``train``."""
