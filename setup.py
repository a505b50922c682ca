#!/usr/bin/env python
"""Package build for tmae-tpu (the reference's setup.py role, minus CUDA: the
native host-ops library is a plain shared object compiled by g++, built here or
lazily on first use by tmae_tpu.utils.native)."""

import subprocess
from pathlib import Path

from setuptools import find_packages, setup
from setuptools.command.build_py import build_py


class BuildWithNative(build_py):
    def run(self):
        src = Path(__file__).parent / 'tmae_tpu' / 'csrc' / 'host_ops.cpp'
        lib = src.parent / 'libtmae_host.so'
        try:
            subprocess.run(
                ['g++', '-O3', '-shared', '-fPIC', '-fopenmp', str(src),
                 '-o', str(lib)],
                check=True,
            )
        except Exception as e:  # pragma: no cover
            print(f'warning: native host-ops build skipped ({e}); '
                  'numpy fallbacks will be used')
        super().run()


setup(
    name='tmae-tpu',
    version='0.1.0',
    description=(
        'TPU-native (JAX/XLA/Pallas) LiDAR 3D detection + temporal-MAE '
        'pretraining framework with the capabilities of T-MAE (ECCV 2024)'
    ),
    packages=find_packages(include=['tmae_tpu', 'tmae_tpu.*',
                                    'tmae_tpu_torch', 'tmae_tpu_torch.*']),
    package_data={'tmae_tpu': ['csrc/*.cpp', 'csrc/*.so'],
                  'tmae_tpu_torch': ['csrc/*.cu', 'csrc/*.cuh']},
    python_requires='>=3.10',
    install_requires=['jax', 'flax', 'optax', 'orbax-checkpoint', 'numpy',
                      'pyyaml'],
    cmdclass={'build_py': BuildWithNative},
)
