from setuptools import find_packages, setup

setup(
    name="qpwcnet_tpu",
    version="0.1.0",
    description=(
        "TPU-native optical-flow framework (PWC-Net family): JAX/XLA/"
        "Pallas cost-volume + warp kernels, frame-interpolation "
        "pretraining, flow-aware augmentation, AGC training, int8 QAT"
    ),
    packages=find_packages(include=["qpwcnet_tpu", "qpwcnet_tpu.*",
                                    "qpwcnet_torch", "qpwcnet_torch.*"]),
    # The PyTorch port builds its CUDA kernels from these sources with
    # nvcc at first use (qpwcnet_torch/ops/cuda/_build.py).
    package_data={"qpwcnet_torch": ["csrc/*.cu", "csrc/*.cuh"]},
    python_requires=">=3.10",
    install_requires=[
        "jax",
        "flax",
        "optax",
        "orbax-checkpoint",
        "numpy",
        "einops",
        "pillow",
    ],
    extras_require={
        "viz": ["matplotlib", "tensorboardX"],
        "test": ["pytest"],
        "torch": ["torch"],
    },
)
