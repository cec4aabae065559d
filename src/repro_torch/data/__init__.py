"""Training data (port of ``repro/data``): the synthetic LM stream with
its chaotic shuffle."""
