"""Settings, timing and checkpoints (port of cudatracerlib_tpu/utils)."""
