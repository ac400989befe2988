"""Hopper kernels for the BS-CSR Top-K SpMV, their plain versions, dispatch."""
