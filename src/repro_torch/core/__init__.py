"""Oscillator systems and nets, training, design-space exploration and
core generation (the paper's flow), and the kernel configuration record."""
