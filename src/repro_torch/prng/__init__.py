"""Chaotic-oscillator PRNG streams and the NIST test subset."""
