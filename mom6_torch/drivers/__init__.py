"""Forcing drivers of the port."""
