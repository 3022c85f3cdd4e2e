"""Per traced step of a sharded cell, in ms: the sum over the step's
collectives of the most minus the least NCCL kernel time among the ranks:
the time the fastest rank waits for the slowest (core/collectives.py)."""
from perfbench.core import collectives


def read(run):
    return collectives.wait_ms(run)
