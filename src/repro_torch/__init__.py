"""PyTorch + CUDA port of the BS-CSR Top-K SpMV system (reference: ``repro``).

Imports ``torch`` and ``numpy`` only; nothing of ``repro`` and no ``jax``.
"""
