"""The optimizer and gradient compression (port of ``repro/optim``)."""
from .adamw import AdamWConfig, apply_updates, global_norm, init_opt_state, \
    schedule
from .compression import (compress_int8, compress_topk, init_error_feedback,
                          wire_bytes)

__all__ = ["AdamWConfig", "apply_updates", "global_norm", "init_opt_state",
           "schedule", "compress_int8", "compress_topk",
           "init_error_feedback", "wire_bytes"]
