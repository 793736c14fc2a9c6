from setuptools import find_packages, setup

setup(
    name="mbe-tpu",
    version="0.1.0",
    description=("TPU-native massively-batched IMBE/AMBE vocoder decode "
                 "framework (JAX/XLA)"),
    packages=find_packages(include=["mbe_tpu", "mbe_tpu.*",
                                    "mbe_tpu_torch", "mbe_tpu_torch.*"]),
    package_data={"mbe_tpu": ["data/*.npz", "data/*.so"],
                  "mbe_tpu_torch": ["csrc/*.cu"]},
    python_requires=">=3.10",
    install_requires=["jax", "numpy"],
    extras_require={"torch": ["torch"]},
)
