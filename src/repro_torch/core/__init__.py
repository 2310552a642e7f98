"""The FLARE operator, its backend registry, the mixer policy and the
spectral analysis of W (Algorithm 1, exported as the reference does)."""
from repro_torch.core.spectral import flare_spectrum, flare_spectrum_dense

__all__ = ["flare_spectrum", "flare_spectrum_dense"]
