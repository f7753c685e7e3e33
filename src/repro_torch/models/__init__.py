"""Model zoo (functional torch over nested-dict params).  The port covers
the dense ``attn`` plan, the hybrid (Mamba-2 + shared attention) and the
ssm (mLSTM + sLSTM) plans; see ``transformer.py``."""
from .transformer import (decode_step, forward, init_decode_state,
                          init_params, layer_plan, prefill)

__all__ = ["decode_step", "forward", "init_decode_state", "init_params",
           "layer_plan", "prefill"]
