"""Model zoo (functional torch over nested-dict params).  This slice ports
the dense ``attn`` plan; see ``transformer.py``."""
from .transformer import (decode_step, forward, init_decode_state,
                          init_params, layer_plan, prefill)

__all__ = ["decode_step", "forward", "init_decode_state", "init_params",
           "layer_plan", "prefill"]
