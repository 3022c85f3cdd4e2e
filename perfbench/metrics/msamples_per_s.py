"""Camera samples (paths) of all passes completed in the window, over the
window's wall time, in millions a second."""


def read(run):
    if run.unit != "pass" or run.trace is not None or run.window_s <= 0:
        return None
    return run.samples / run.window_s / 1e6
