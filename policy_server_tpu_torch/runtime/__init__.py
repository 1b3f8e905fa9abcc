"""Serving runtime: the micro-batcher."""
