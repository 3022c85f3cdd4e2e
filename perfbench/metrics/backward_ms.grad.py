"""Host wall of the backward, from a synchronize after the forward to a
synchronize after the backward, the mean over the traced steps, in ms."""


def read(run):
    walls = run.spans.get("backward")
    if run.unit != "step" or not walls:
        return None
    return sum(walls) / len(walls) * 1e3
