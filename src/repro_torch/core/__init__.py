# MERINDA model recovery (the GRU neural-flow replacement of NODE layers),
# the EMILY / PINN+SR baselines it is evaluated against, and the
# fleet-twinning production layer: the JAX package's repro.core exports.
from repro_torch.core.emily import Emily, EmilyConfig
from repro_torch.core.fleet import FleetConfig, FleetMerinda
from repro_torch.core.library import PolyLibrary, make_library, n_library_terms
from repro_torch.core.merinda import Merinda, MerindaConfig
from repro_torch.core.pinn_sr import PinnSR, PinnSRConfig
from repro_torch.core.sparse_regression import masked_ridge, stlsq
from repro_torch.core.trainer import FitResult, fit

__all__ = [
    "Emily", "EmilyConfig", "FleetConfig", "FleetMerinda", "PolyLibrary",
    "make_library", "n_library_terms", "Merinda", "MerindaConfig", "PinnSR",
    "PinnSRConfig", "masked_ridge", "stlsq", "FitResult", "fit",
]
