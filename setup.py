"""Package setup (console-script surface mirrors reference setup.py:37-48)."""

import os

from setuptools import find_packages, setup

version = "0.1.0"

setup(
    name="polymer_chemprop_tpu",
    version=version,
    description=("TPU-native message passing neural networks for molecular "
                 "and polymer (wD-MPNN) property prediction"),
    license="MIT",
    packages=find_packages(exclude=["tests", "tests.*"]),
    # polymer_chemprop_tpu_torch (the PyTorch/CUDA port) is found by
    # find_packages; its CUDA and C++ sources are built at first use, and
    # it reads its own copy of the rdkit_2d_normalized CDF table
    package_data={"polymer_chemprop_tpu": ["py.typed"],
                  "polymer_chemprop_tpu_torch": ["csrc/*.cu", "csrc/*.cuh",
                                                   "native/src/*",
                                                   "features/data/*.npz"]},
    entry_points={
        "console_scripts": [
            "chemprop_train=polymer_chemprop_tpu.cli:chemprop_train",
            "chemprop_predict=polymer_chemprop_tpu.cli:chemprop_predict",
            "chemprop_fingerprint=polymer_chemprop_tpu.cli:chemprop_fingerprint",
            "chemprop_hyperopt=polymer_chemprop_tpu.cli:chemprop_hyperopt",
            "sklearn_train=polymer_chemprop_tpu.sklearn_train:sklearn_train",
            "sklearn_predict=polymer_chemprop_tpu.sklearn_predict:sklearn_predict",
            "chemprop_interpret=polymer_chemprop_tpu.interpret:chemprop_interpret",
            "chemprop_web=polymer_chemprop_tpu.web.app:chemprop_web",
            "chemprop_ssl_pretrain=polymer_chemprop_tpu.ssl:ssl_pretrain_cli",
            "chemprop_torch=polymer_chemprop_tpu_torch.cli:main",
        ]
    },
    install_requires=[
        "jax",
        "numpy",
        "optax",
        "scikit-learn",
        "pandas",
    ],
    python_requires=">=3.12",
    keywords=["chemistry", "machine learning", "property prediction",
              "message passing neural network", "polymer", "TPU", "JAX"],
)
