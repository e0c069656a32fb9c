"""Continuous-batching serving over a paged KV cache (``server`` holds the
entry points)."""
