"""Host input pipeline of the port: level constants, the seeded loader."""
