"""Oscillator model containers and the kernel configuration record."""
