"""Command-line tooling (reference: ray ``python/ray/scripts/scripts.py``)."""
