"""Hand-written Hopper kernels and their plain torch versions.

<name>.py        — the wrapper (kernel on CUDA, plain version on the CPU),
                   the plain version and the launch counter
csrc/<name>.cu   — the CUDA C++ source (sm_90a, plain C interface)
build.py         — nvcc -> shared library -> ctypes, at first use
ops.py           — the entry points the model calls
ref.py           — dense torch oracles

Kernels: flash_attention (the prefill of every attention layer).
"""
from . import flash_attention, ops, ref

__all__ = ["flash_attention", "ops", "ref"]
