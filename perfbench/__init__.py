"""The benchmark of the PyTorch and CUDA port on one NVIDIA H100.

    python3 -m perfbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

runs one cell of BENCHMARK.json from the root of a checkout and prints
its result as the last line of standard output (perfbench/run.py).
"""
