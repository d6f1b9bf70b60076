"""Utilities of the port: the speculative hit replay, training fixtures
and sample export."""
