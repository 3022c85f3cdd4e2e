from . import records, rng, samplers  # noqa: F401
from .rng import Sampler  # noqa: F401
