"""Sharding rules over a ``DeviceMesh`` (port of ``repro/parallel``)."""
from .sharding import (axis_sizes, batch_specs, constrain, decode_state_specs,
                       distribute, dp_axes, opt_moment_specs, param_specs,
                       pin_stack_cotangent, sanitize, sharding_ctx,
                       to_placements)

__all__ = ["axis_sizes", "batch_specs", "constrain", "decode_state_specs",
           "distribute", "dp_axes", "opt_moment_specs", "param_specs",
           "pin_stack_cotangent", "sanitize", "sharding_ctx",
           "to_placements"]
