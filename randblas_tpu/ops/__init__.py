"""Compute kernels: counter-addressed fill, COO apply, RNG-in-GEMM sketch."""
