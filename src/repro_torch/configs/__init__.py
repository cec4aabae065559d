"""LM configurations (port of ``repro/configs``): the ten assigned
architectures and their reduced smoke variants, copied."""
