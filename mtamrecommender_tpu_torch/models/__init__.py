"""Model definitions of the port (MTAM so far)."""
