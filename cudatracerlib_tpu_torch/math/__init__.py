from . import (dispersion, fresnel, frame, microfacet, montecarlo, rough_transmittance,  # noqa: F401
               spectral, spectrum, vecmath, warp)
from .frame import Frame  # noqa: F401
