"""Ensemble data assimilation of the port."""
