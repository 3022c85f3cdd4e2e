"""The program's host reads a traced step: each place it makes the host wait
for the card's stream (`host_reads.<site>`: a device value read on the host,
or a host value copied to the card, which PyTorch ends with a stream
synchronize). The step's own read of the loss (drivers/grad_steps.py) is
not the program's and is not counted."""
from perfbench.core import program_counters


def read(run):
    c = program_counters.traced(run)
    if run.unit != "step" or c is None or not run.units:
        return None
    return program_counters.total(c, "host_reads.") / run.units
