"""Traffic drivers, one module per kind (`<driver>.py`, with `run(...)`),
named by a traffic file's "driver" key."""
