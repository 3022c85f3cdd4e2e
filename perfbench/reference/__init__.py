"""The plain reference: the same estimator as the program, written in plain
PyTorch from its published semantics, replaying the same counter-based
random streams. It imports nothing of the program (cudatracerlib_tpu_torch),
nor JAX, nor the JAX package, and takes nothing the program made: it builds
its own acceleration structure, light tables and camera from the scene
arrays the benchmark generated. `dtype` runs it in another precision (the
control of the comparison runs it in bfloat16)."""
