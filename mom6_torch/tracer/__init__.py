"""Tracer transport and column physics of the port."""
