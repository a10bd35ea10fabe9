"""Fused study inference."""
