"""Model code of the port: shared blocks, attention, the dense decoder."""
