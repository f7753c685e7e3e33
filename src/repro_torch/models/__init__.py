"""Model zoo (functional torch over nested-dict params).  The port covers
every layer plan of the reference: the dense ``attn`` plan, MoE
(``attn_moe``), the hybrid (Mamba-2 + shared attention) and the ssm
(mLSTM + sLSTM) plans, and the training loss; see ``transformer.py``."""
from .moe import init_moe, moe_block
from .transformer import (PadLength, decode_step, fill_pad_length, forward,
                          init_decode_state, init_params, layer_plan,
                          loss_and_metrics, pad_length, prefill)

__all__ = ["PadLength", "decode_step", "fill_pad_length", "forward",
           "init_decode_state", "init_moe", "init_params", "layer_plan",
           "loss_and_metrics", "moe_block", "pad_length", "prefill"]
