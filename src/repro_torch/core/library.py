"""Polynomial feature library for sparse model recovery.

The recovered model has the form  dY/dt = Theta @ Phi(Y, U)  where Phi is a
library of monomials of total degree <= `order` over the augmented variable
vector  X~ = [1, Y_1..Y_n, U_1..U_m].

Each library term is stored as `order` indices into X~ (index 0 is the
constant 1), so evaluation is a gather + product — the formulation the RK4
kernel (csrc/rk4_poly.cu) consumes.  The enumeration, `term_indices` and
`names` are identical to the JAX package's library.
"""
from __future__ import annotations

import itertools
import math
from dataclasses import dataclass, field

import numpy as np
import torch

__all__ = ["PolyLibrary", "make_library", "n_library_terms"]


def n_library_terms(n_vars: int, order: int) -> int:
    """Number of monomials of total degree <= order in n_vars variables,
    C(order + n_vars, n_vars)."""
    return math.comb(order + n_vars, n_vars)


@dataclass(frozen=True, eq=False)
class PolyLibrary:
    """A fixed polynomial library Phi over states Y (n dims) and inputs U
    (m dims).  Hash/eq are defined by (n, m, order)."""

    n: int                      # state dimension |Y|
    m: int                      # input dimension |U|
    order: int                  # max total degree M
    term_indices: np.ndarray    # [L, order] int32 indices into [1, Y, U]
    names: tuple[str, ...] = field(default=())
    _on_device: dict = field(default_factory=dict, repr=False)

    def __hash__(self):
        return hash((self.n, self.m, self.order))

    def __eq__(self, other):
        return (isinstance(other, PolyLibrary)
                and (self.n, self.m, self.order)
                == (other.n, other.m, other.order))

    @property
    def size(self) -> int:
        return int(self.term_indices.shape[0])

    def indices_on(self, device) -> torch.Tensor:
        """`term_indices` as an int32 tensor on `device` (cached)."""
        device = torch.device(device)
        t = self._on_device.get(device)
        if t is None:
            t = torch.as_tensor(self.term_indices, dtype=torch.int32,
                                device=device)
            self._on_device[device] = t
        return t

    # ------------------------------------------------------------------ #
    def eval(self, y, u=None):
        """Evaluate Phi(Y, U) -> [..., L].  y: [..., n], u: [..., m] or None
        (when m == 0)."""
        parts = [torch.ones_like(y[..., :1]), y]
        if self.m:
            if u is None:
                raise ValueError(f"library has m={self.m} inputs but u is "
                                 "None")
            parts.append(u)
        aug = torch.cat(parts, dim=-1)                       # [..., 1+n+m]
        gathered = aug[..., self.indices_on(aug.device)]     # [..., L, order]
        return torch.prod(gathered, dim=-1)

    # ------------------------------------------------------------------ #
    def term_name(self, j: int) -> str:
        return self.names[j]

    def coeff_dict(self, theta, state_names=None, atol: float = 1e-8):
        """Theta [n, L] as {state: {term: coeff}}, terms above `atol`."""
        theta = np.asarray(torch.as_tensor(theta).detach().cpu())
        state_names = state_names or [f"dy{i}/dt" for i in range(self.n)]
        return {state_names[i]: {self.names[j]: float(theta[i, j])
                                 for j in range(self.size)
                                 if abs(theta[i, j]) > atol}
                for i in range(self.n)}

    # ------------------------------------------------------------------ #
    def theta_from_terms(self, rows: list[dict[str, float]]) -> np.ndarray:
        """Build a dense Theta [n, L] (float64) from per-state
        {term_name: coeff} dicts."""
        if len(rows) != self.n:
            raise ValueError(f"expected {self.n} rows, got {len(rows)}")
        name_to_j = {nm: j for j, nm in enumerate(self.names)}
        theta = np.zeros((self.n, self.size), dtype=np.float64)
        for i, row in enumerate(rows):
            for nm, c in row.items():
                key = _canonical_name(nm)
                if key not in name_to_j:
                    raise KeyError(f"term {nm!r} (canonical {key!r}) not in "
                                   f"library (n={self.n}, m={self.m}, "
                                   f"order={self.order})")
                theta[i, name_to_j[key]] = c
        return theta


def _canonical_name(name: str) -> str:
    """Canonicalize 'y1*y0' -> 'y0*y1', '1' stays '1'."""
    if name in ("1", ""):
        return "1"
    return "*".join(sorted(name.split("*")))


def make_library(n: int, m: int = 0, order: int = 2) -> PolyLibrary:
    """Enumerate all monomials of total degree <= order over [Y(n), U(m)].

    Term j is the product of `order` entries of [1, Y, U]; lower-degree terms
    pad with index 0 (the constant 1).  L = C(order + n + m, n + m).
    """
    n_vars = n + m

    def vname(k: int) -> str:
        return f"y{k - 1}" if k <= n else f"u{k - 1 - n}"

    terms: list[tuple[int, ...]] = []
    names: list[str] = []
    for d in range(order + 1):
        for combo in itertools.combinations_with_replacement(
                range(1, n_vars + 1), d):
            terms.append(combo + (0,) * (order - d))
            names.append("1" if d == 0
                         else "*".join(sorted(vname(k) for k in combo)))
    lib = PolyLibrary(n=n, m=m, order=order,
                      term_indices=np.asarray(terms, dtype=np.int32),
                      names=tuple(names))
    if lib.size != n_library_terms(n_vars, order):
        raise AssertionError("library enumeration miscounted")
    return lib
