"""Build the native IO runtime extension:

    python setup.py build_ext --inplace

The package works without it (pure-numpy fallbacks in vampomi_tpu.io), but
the native path streams f64 marker slabs into f32 with no full-size f64
temporary and parallelizes file reads across threads.
"""

from setuptools import Extension, find_packages, setup

setup(
    name="vampomi_tpu",
    version="0.1.0",
    packages=find_packages(include=["vampomi_tpu", "vampomi_tpu.*",
                                    "vampomi_tpu_torch", "vampomi_tpu_torch.*"]),
    package_data={"vampomi_tpu_torch": ["csrc/*.cu", "csrc/*.cuh", "csrc/*.cpp"]},
    ext_modules=[
        Extension(
            "vampomi_tpu._native",
            sources=["native/vampomi_native.cpp"],
            extra_compile_args=[
                "-O3", "-std=c++17", "-pthread", "-D_FILE_OFFSET_BITS=64",
            ],
            extra_link_args=["-pthread"],
            language="c++",
            optional=True,  # pure-numpy fallbacks exist; never block install
        )
    ],
)
