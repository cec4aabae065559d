"""The LM stack's models (port of ``repro/models``): layers, GQA / SWA
attention, MoE and the transformer of the attention family."""
