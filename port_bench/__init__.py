"""The benchmark of the PyTorch + CUDA port (`repro_torch`) on the card.

`run.py` runs one cell; BENCHMARK.json at the repository root names the
cells, their configurations (`configs/`), traffic mixes (`traffic/`),
limits of the correctness check (`limits/`) and per-layer metrics
(`metrics/`).  Nothing here imports JAX or the JAX package.
"""
