"""The collectives' share of their roofline in a sharded cell's traced
steps: a step's buffer bytes (core/collectives.step_bytes) over
allreduce_ms.grad4, over the per-direction peak of a card's link to the
others (the configuration's `link`, read on the machine); between 0 and 1."""
from perfbench.core import collectives


def read(run):
    return collectives.link_share(run)
