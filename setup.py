"""Packaging (reference ``setup.py``), TPU-native dependency set."""

from setuptools import find_packages, setup

setup(
    name="fusiontransformer_tpu",
    version="0.1.0",
    description=("TPU-native camera+LiDAR point-wise segmentation framework "
                 "(JAX/XLA/Pallas re-design of FusionTransformer)"),
    packages=find_packages(exclude=("tests",)),
    package_data={"fusiontransformer_tpu.native": ["*.cpp"],
                  "fusiontransformer_tpu_torch": ["csrc/*.cu",
                                                  "csrc/*.cuh"]},
    python_requires=">=3.10",
    install_requires=[
        "jax",
        "flax",
        "optax",
        "orbax-checkpoint",
        "numpy",
        "pyyaml",
        "pillow",
        "tabulate",
        "tqdm",
    ],
    extras_require={
        "data": ["nuscenes-devkit"],
        "convert": ["torch"],
        "viz": ["matplotlib"],
    },
)
