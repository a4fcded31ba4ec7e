"""Decoding one long capture in blocks of time (``parallel/stream.py``)."""
