"""Diagnostics of the port: the ocean.stats sums and the depth list."""
