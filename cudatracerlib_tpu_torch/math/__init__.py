from . import (compression, dispersion, fresnel, frame, kernels, microfacet,  # noqa: F401
               montecarlo, quadrature, rough_transmittance, spectral, spectrum, spline,
               vecmath, warp)
from .frame import Frame  # noqa: F401
