"""PyTorch + CUDA port of the online digital-twinning system.

The layout follows the JAX package `repro` module for module; this package
imports `torch` and numpy only, never `jax` or `repro`.  The online serving
path is ported: `twin.server.TwinServer` (tick, predict, scenario) over
`core.fleet.FleetMerinda`, with the two hot blocks as hand-written CUDA
kernels for Hopper:

  kernels/gru   fused GRU scan            csrc/gru_scan.cu
  kernels/rk4   fused RK4 polynomial ODE  csrc/rk4_poly.cu

Entry points run on the CUDA card unless the caller passes device="cpu",
which runs each kernel's plain PyTorch version instead.
"""
