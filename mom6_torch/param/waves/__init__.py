"""Surface-wave coupling of the port."""
