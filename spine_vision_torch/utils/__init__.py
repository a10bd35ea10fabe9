"""Utilities of the port: the quality-parity suite."""
