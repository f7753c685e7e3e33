"""Hand-written Hopper kernels and their plain torch versions.

<name>.py        — the wrapper (kernel on CUDA, plain version on the CPU),
                   the plain version and the launch counter
csrc/<name>.cu   — the CUDA C++ source (sm_90a, plain C interface)
                   (flash_attention_bwd.cu: flash attention's backward;
                   ssd_scan_bwd.cu, slstm_scan_bwd.cu likewise)
build.py         — nvcc -> shared library -> ctypes, at first use
common.py        — the launch counter and the refusal of inputs that need
                   a gradient (the kernels without a backward), shared by
                   the wrappers
ops.py           — the entry points the model calls
ref.py           — dense torch oracles

Kernels: flash_attention (the prefill of every attention layer), ssd_scan
(the prefill of every Mamba-2 and mLSTM layer), slstm_scan (every sLSTM
layer's recurrence: prefill, decode and training), adamw (the optimizer's
update and gradient norm, every training step), and the paper's node
kernels matmul, copy and stencil (the payloads of the task runtime).
"""
from . import (adamw, copy, flash_attention, matmul, ops, ref, slstm_scan,
               ssd_scan, stencil)

__all__ = ["adamw", "copy", "flash_attention", "matmul", "ops", "ref",
           "slstm_scan", "ssd_scan", "stencil"]
