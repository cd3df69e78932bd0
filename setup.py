from setuptools import find_packages, setup

setup(
    name="svision-tpu",
    version="0.1.0",
    description=("TPU-native structural-variant calling engine with the "
                 "capabilities of SVision (JAX/XLA/Pallas)"),
    packages=find_packages(include=["svision_tpu", "svision_tpu.*",
                                    "svision_tpu_torch",
                                    "svision_tpu_torch.*"]),
    python_requires=">=3.10",
    install_requires=["jax", "numpy", "optax"],
    extras_require={"torch": ["torch>=2.11", "numpy>=1.26"]},
    entry_points={
        "console_scripts": [
            "svision-tpu = svision_tpu.cli:main",
            "svision-tpu-torch = svision_tpu_torch.cli:main",
        ],
    },
    package_data={"svision_tpu.io": ["native/Makefile", "native/*.cc"],
                  "svision_tpu_torch": ["csrc/*.cu", "csrc/*.cuh"],
                  "svision_tpu_torch.io": ["native/Makefile", "native/*.cc",
                                           "native/build.sh"]},
)
