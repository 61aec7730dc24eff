"""Build the native (C++) setup kernels: python setup.py build_ext --inplace.

The extension is optional — every caller falls back to the vectorized numpy
implementation when `_ngsamg_native` is absent.
"""

import numpy as np
from setuptools import Extension, setup

setup(
    name="ngsamg_tpu",
    version="0.1.0",
    packages=["ngsamg_tpu"] + [
        "ngsamg_tpu_torch" + sub
        for sub in ("", ".apps", ".coarsen", ".factory", ".mesh", ".ops",
                    ".precond", ".smoothers", ".solve", ".sparse",
                    ".transfer", ".utils")
    ],
    package_data={"ngsamg_tpu_torch": ["csrc/*.cu"]},
    ext_modules=[
        Extension(
            "ngsamg_tpu.native._ngsamg_native",
            sources=["ngsamg_tpu/native/kernels.cpp"],
            include_dirs=[np.get_include()],
            extra_compile_args=["-O3", "-std=c++17", "-march=native"],
        )
    ],
)
