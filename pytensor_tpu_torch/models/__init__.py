"""Model graphs built on the port."""
