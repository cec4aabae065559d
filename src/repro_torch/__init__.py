"""PyTorch/CUDA port of the HENNC chaotic-oscillator PRNG stack.

Mirrors the JAX package ``repro`` subpackage by subpackage (``kernels``,
``core``, ``prng``, ``serve``) and imports nothing of it.  Entry points run
on the CUDA card unless the caller passes ``device="cpu"``, where every
kernel wrapper takes its plain PyTorch version instead.
"""
