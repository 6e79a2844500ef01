from setuptools import find_packages, setup

setup(
    name="paddle_tpu",
    version="0.1.0",
    description="TPU-native deep-learning framework with PaddlePaddle's "
                "capabilities, built on jax/XLA/Pallas",
    packages=find_packages(include=["paddle_tpu", "paddle_tpu.*",
                                    "paddle_tpu_torch", "paddle_tpu_torch.*"]),
    package_data={"paddle_tpu_torch": ["csrc/*.cu"]},
    python_requires=">=3.10",
    install_requires=["jax", "numpy"],
)
