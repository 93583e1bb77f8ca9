"""The plain reference of the benchmark's configurations: float32
PyTorch, independent of the measured package (it imports nothing of it),
against which each run's outputs are judged."""
