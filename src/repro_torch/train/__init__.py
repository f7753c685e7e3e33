"""Training: the step functions and the fault-tolerant trainer (port of
``repro/train``)."""
from .train_step import (make_decode_step, make_forward_step, make_grad_step,
                         make_prefill_step, make_train_step)

__all__ = ["make_decode_step", "make_forward_step", "make_grad_step",
           "make_prefill_step", "make_train_step"]
