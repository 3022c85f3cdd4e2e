"""The benchmark of cudatracerlib_tpu_torch (the PyTorch and CUDA port).

`python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>`
runs one cell of BENCHMARK.json once and prints one JSON line. Cells,
configurations, traffic mixes, metrics and limits are found by name in the
folders beside this file; nothing here imports JAX or the JAX package.
"""
