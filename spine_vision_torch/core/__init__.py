"""Task registry and host-side decode."""
