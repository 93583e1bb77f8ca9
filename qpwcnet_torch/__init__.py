"""qpwcnet_torch — the PyTorch / CUDA port of qpwcnet_tpu for NVIDIA Hopper.

Mirrors the JAX package's module paths and names. It imports torch and
never jax; the JAX package is the reference each module is tested
against (tests/test_torch_*.py).

  - NHWC at public function boundaries, as in the JAX package; inside the
    model, logical NCHW in channels_last memory.
  - Every Pallas TPU kernel on the flow-inference path is a hand-written
    CUDA kernel for sm_90a (``qpwcnet_torch/csrc``), built with nvcc at
    first use and bound with ctypes (``ops/cuda/_build.py``). CPU tensors
    take each kernel's plain PyTorch version.
  - An explicit ``device`` argument and ``torch.Generator`` seeds; no
    module-level device choice.
"""

__version__ = "0.1.0"
