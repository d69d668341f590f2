"""Modulation schemes of the port (constellation tables)."""
