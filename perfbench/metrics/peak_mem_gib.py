"""torch.cuda.max_memory_allocated() over the window (reset at its start), GiB."""


def read(run):
    if run.trace is not None or run.peak_bytes <= 0:
        return None
    return run.peak_bytes / 2 ** 30
