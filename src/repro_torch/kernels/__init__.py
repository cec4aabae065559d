"""Oscillator kernels: hand-written CUDA for Hopper, plain PyTorch versions, and the integer word pipeline."""
