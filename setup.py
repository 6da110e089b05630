"""Packaging for the TPU-native FACT/FACT_CLIP framework.

Mirrors the reference's editable-install workflow (/root/reference/setup.py:1-27)
with JAX-stack dependencies instead of torch.
"""

from setuptools import find_packages, setup

setup(
    name="fact_clip_tpu",
    version="0.1.0",
    description="TPU-native temporal action segmentation (FACT / FACT_CLIP capabilities) in JAX",
    packages=find_packages(include=["fact_clip_tpu", "fact_clip_tpu.*",
                                    "fact_clip_tpu_torch", "fact_clip_tpu_torch.*"]),
    package_data={"fact_clip_tpu.configs": ["*.yaml"]},
    include_package_data=True,
    python_requires=">=3.10",
    install_requires=[
        "jax",
        "flax",
        "optax",
        "orbax-checkpoint",
        "numpy",
        "scipy",
        "pyyaml",
        "einops",
    ],
    extras_require={
        "text": ["transformers>=4.30"],  # offline CLIP text-embedding tool only
        "test": ["pytest"],
    },
)
