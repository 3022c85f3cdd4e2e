from . import fresnel, frame, microfacet, montecarlo, rough_transmittance, vecmath, warp  # noqa: F401
from .frame import Frame  # noqa: F401
