"""nbody_tpu_torch: the PyTorch / CUDA port of nbody_tpu for NVIDIA Hopper.

Module paths mirror ``nbody_tpu`` so each counterpart is easy to find; the
JAX package stays the reference the port is tested against.  This package
imports torch and numpy only, never jax.  Its CUDA kernels live in
``csrc/`` and are compiled with nvcc at first use (ops/kernels/build.py).
"""
