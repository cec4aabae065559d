"""Training substrate of the port (``repro/train``): the optimizer."""
