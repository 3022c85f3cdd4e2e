"""Per traced step of a sharded cell, in ms: the sum over the step's
collectives (the film's all-reduce in the forward, the gradients' after the
backward) of the least NCCL kernel time among the ranks: the transfer, which
the last rank to arrive barely waits for (core/collectives.py)."""
from perfbench.core import collectives


def read(run):
    return collectives.transfer_ms(run)
