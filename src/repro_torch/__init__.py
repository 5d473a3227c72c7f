"""PyTorch + CUDA port of the online digital-twinning system.

The layout follows the JAX package `repro` module for module; this package
imports `torch` and numpy only, never `jax` or `repro`.  Three paths are
ported, each through hand-written CUDA kernels for Hopper:

  * online twin serving: `twin.server.TwinServer` (tick, predict, scenario)
    over `core.fleet.FleetMerinda`;
  * LM serving of RWKV-6 (`configs.get_arch("rwkv6-3b")`): `models.zoo.build`
    and `serve.engine.ServeEngine` (admit -> prefill, step -> decode_step);
  * offline model recovery: `systems.simulate`, `core.trainer.fit` over
    `core.merinda.Merinda` (and the EMILY and PINN+SR baselines),
    `Merinda.recover`, `core.metrics`, `launch.train --merinda`.

  kernels/gru           fused GRU scan                 csrc/gru_scan.cu
  kernels/rk4           fused RK4 polynomial ODE       csrc/rk4_poly.cu
  kernels/linear_scan   chunked decayed linear scan    csrc/linear_scan.cu

Entry points run on the CUDA card unless the caller passes device="cpu",
which runs each kernel's plain PyTorch version instead.
"""
