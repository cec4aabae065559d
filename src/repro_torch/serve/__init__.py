"""Batched multi-client PRNG serving."""
