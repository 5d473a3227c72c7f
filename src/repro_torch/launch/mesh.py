"""The device the launchers plan for: one NVIDIA H100, and a mesh stand-in.

The JAX package builds 16x16 (and 2x16x16) TPU meshes here.  The port
runs on one card, so both builders return a one-device `Mesh` that
carries what the sharding rules (distributed/sharding.py) read: axis
names and sizes.  Nothing here touches a device.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

__all__ = ["Mesh", "make_production_mesh", "make_local_mesh", "HW"]


@dataclass(frozen=True)
class Mesh:
    """Axis names and sizes, as `jax.sharding.Mesh` exposes them."""
    axis_sizes: tuple
    axis_names: tuple

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The one card: a (data=1, model=1) mesh.  One card has no pod, so
    `multi_pod=True` raises."""
    if multi_pod:
        raise ValueError("multi_pod: one H100 has no pod axis; the port "
                         "plans for a single card")
    return make_local_mesh()


def make_local_mesh(data: int = 1, model: int = 1) -> Mesh:
    """A (data, model) mesh; the port runs on one card, so 1 x 1."""
    if data * model != 1:
        raise ValueError(f"a {data}x{model} mesh needs {data * model} "
                         "devices; the port plans for one card")
    return Mesh((data, model), ("data", "model"))


class HW:
    """NVIDIA H100 SXM5 (H100 80GB HBM3, 700 W) datasheet figures, dense
    (no sparsity)."""
    PEAK_BF16_FLOPS = 989e12        # 989 TFLOP/s bf16 tensor cores
    PEAK_TF32_FLOPS = 495e12        # 495 TFLOP/s TF32 tensor cores
    PEAK_F32_FLOPS = 67e12          # 67 TFLOP/s f32 outside them
    HBM_BW = 3.35e12                # 3.35 TB/s HBM3
    ICI_BW = math.inf               # no interconnect: one card, no wire
    HBM_BYTES = 80 * 10 ** 9        # 80 GB
