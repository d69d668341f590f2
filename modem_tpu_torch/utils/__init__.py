"""Bit packing helpers of the port."""
