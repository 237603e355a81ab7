"""Vertical (column) parameterizations of the port."""
